"""The port's trainer input path (utils/audio_io.py, utils/native.py,
data/dataset.py) against the JAX package's, on the same files and seeds.

The cases of tests/test_data_metrics.py (WAV round trip, labels and
shapes, batches, padding, the Google Drive confirm flow) and
tests/test_native.py (sample count, batch load, padding, the dataset's
native path, the auto-download) run on both packages; the port's output
must equal JAX's (the same numpy and scipy code, the same C++ loader).
Added: ``batches(shuffle=True)`` equal to JAX's batch for batch, native
and scipy, and the fall-back after a native failure, whose crop starts
come from the same stream as JAX's (the native path draws a batch's starts
before it fails).  The network is faked wherever the download code runs.
"""

import io
import os
import tarfile

import numpy as np
import pytest

from speakerguard_tpu.data import dataset as jax_dataset
from speakerguard_tpu.utils import audio_io as jax_audio_io
from speakerguard_tpu.utils import native as jax_native

from speakerguard_tpu_torch.data import dataset as D
from speakerguard_tpu_torch.utils import native
from speakerguard_tpu_torch.utils.audio_io import read_wav, write_wav

from fixtures import make_wav_dataset
from test_torch_kenan import one_cpu_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wav_root(tmp_path_factory):
    rng = np.random.default_rng(11)
    tmpdir = str(tmp_path_factory.mktemp("wavs"))
    return make_wav_dataset(tmpdir, rng, n_spks=3, utts_per_spk=2,
                            length=8000)


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, native.build_error()
    return lib


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_wav_roundtrip_matches_jax(tmp_path, rng):
    wav = (rng.standard_normal(1000) * 0.1).astype(np.float32)
    p, q = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    write_wav(p, wav)
    jax_audio_io.write_wav(q, wav)
    assert open(p, "rb").read() == open(q, "rb").read()
    back = read_wav(p)
    np.testing.assert_array_equal(back, jax_audio_io.read_wav(p))
    np.testing.assert_allclose(back, wav, atol=1.0 / 32768)


def test_dataset_labels_and_shapes_match_jax(wav_root):
    root, name, spk_ids = wav_root
    ds = D.Dataset(spk_ids, root, name, normalize=False, wav_length=4000)
    jds = jax_dataset.Dataset(spk_ids, root, name, normalize=False,
                              wav_length=4000)
    assert len(ds) == len(jds) == 6
    for i in range(len(ds)):
        (wav, label), (jwav, jlabel) = ds[i], jds[i]
        assert wav.shape == (1, 4000) and label == jlabel
        np.testing.assert_array_equal(wav, jwav)
    assert np.abs(ds[0][0]).max() > 2  # origin domain (int16 scale)
    ds2 = D.Dataset(["spk1"], root, name)
    labels = [ds2[i][1] for i in range(len(ds2))]
    assert set(labels) == {0, -1}
    jds2 = jax_dataset.Dataset(["spk1"], root, name)
    assert labels == [jds2[i][1] for i in range(len(jds2))]


def test_dataset_batches_match_jax(wav_root, lib):
    root, name, spk_ids = wav_root
    ds = D.Dataset(spk_ids, root, name, wav_length=4000,
                   return_file_name=True)
    got = list(ds.batches(4))
    assert got[0][0].shape == (4, 1, 4000) and len(got[0][2]) == 4
    assert sum(b[0].shape[0] for b in got) == 6
    assert ds.loader_counts == {"native": 2, "scipy": 0}
    jds = jax_dataset.Dataset(spk_ids, root, name, wav_length=4000,
                              return_file_name=True)
    _equal_batches(got, list(jds.batches(4)))


def test_dataset_pad_short_matches_jax(wav_root):
    root, name, spk_ids = wav_root
    wav, _ = D.Dataset(spk_ids, root, name, wav_length=10000)[0]
    assert wav.shape == (1, 10000) and np.all(wav[0, 8000:] == 0)
    np.testing.assert_array_equal(
        wav, jax_dataset.Dataset(spk_ids, root, name, wav_length=10000)[0][0])


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "scipy"])
@pytest.mark.parametrize("normalize", [True, False],
                         ids=["scale", "origin"])
def test_shuffled_batches_equal_jax(tmp_path, lib, use_native, normalize):
    """Three epochs of shuffled, cropped and padded batches (the files run
    from 2,000 to 9,000 samples around a 5,000-sample crop) equal JAX's
    for the same seed, batch for batch, and each loader is recorded."""
    rng = np.random.default_rng(5)
    root = tmp_path / "Mixed"
    for s in range(3):
        (root / f"spk{s}").mkdir(parents=True)
        for u in range(3):
            n = int(rng.integers(2000, 9000))
            write_wav(str(root / f"spk{s}" / f"spk{s}-{u}.wav"),
                      (rng.standard_normal(n) * 0.1).astype(np.float32))
    spk_ids = ["spk0", "spk2"]  # spk1 is an imposter (label -1)
    kw = dict(normalize=normalize, wav_length=5000, seed=3)
    ds = D.Dataset(spk_ids, str(tmp_path), "Mixed", **kw)
    jds = jax_dataset.Dataset(spk_ids, str(tmp_path), "Mixed", **kw)
    for _ in range(3):
        _equal_batches(list(ds.batches(4, shuffle=True,
                                       use_native=use_native)),
                       list(jds.batches(4, shuffle=True,
                                        use_native=use_native)))
    served = "native" if use_native else "scipy"
    assert ds.loader_counts[served] == 9
    assert sum(ds.loader_counts.values()) == 9


def test_native_failure_falls_back_like_jax(wav_root, lib, monkeypatch):
    """A file the native loader cannot probe sends its batch to the scipy
    path after the starts drawn so far: the port's batches equal JAX's
    under the same failure, and the fall-back is recorded."""
    root, name, spk_ids = wav_root

    def failing(mod):
        real = mod.wav_num_samples
        return lambda p: None if p.endswith("spk1-0.wav") else real(p)

    monkeypatch.setattr(native, "wav_num_samples", failing(native))
    monkeypatch.setattr(jax_native, "wav_num_samples", failing(jax_native))
    kw = dict(wav_length=3000, seed=9)
    ds = D.Dataset(spk_ids, root, name, **kw)
    got = list(ds.batches(2, shuffle=True))
    _equal_batches(got, list(jax_dataset.Dataset(spk_ids, root, name, **kw)
                             .batches(2, shuffle=True)))
    assert ds.loader_counts == {"native": 2, "scipy": 1}


def test_native_builds_outside_the_tracked_library(lib):
    """The port's library lives in its own gitignored build directory; the
    JAX package's native/build/libwavloader.so is not the one it loads."""
    path = native.library_path()
    assert path.startswith(os.path.join(ROOT, "speakerguard_tpu_torch",
                                        "csrc", "_build") + os.sep)
    assert os.path.exists(path)
    assert os.path.realpath(path) != os.path.realpath(os.path.join(
        ROOT, "native", "build", "libwavloader.so"))
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "speakerguard_tpu_torch/csrc/_build/" in ignored


def test_num_samples(tmp_path, lib, rng):
    wav = (rng.standard_normal(1234) * 0.1).astype(np.float32)
    p = str(tmp_path / "a.wav")
    write_wav(p, wav)
    assert native.wav_num_samples(p) == jax_native.wav_num_samples(p) == 1234


def test_load_batch_matches_scipy_and_jax(tmp_path, lib, rng):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"{i}.wav")
        write_wav(p, (rng.standard_normal(2000) * 0.2).astype(np.float32))
        paths.append(p)
    out = native.load_wav_batch(paths, 1500, [100] * 4, scale=1.0)
    assert out is not None and out.shape == (4, 1500)
    for i, p in enumerate(paths):
        np.testing.assert_allclose(out[i], read_wav(p)[100:1600], atol=1e-6)
    np.testing.assert_array_equal(
        out, jax_native.load_wav_batch(paths, 1500, [100] * 4, scale=1.0))


def test_load_batch_pads(tmp_path, lib, rng):
    p = str(tmp_path / "s.wav")
    write_wav(p, (rng.standard_normal(500) * 0.2).astype(np.float32))
    out = native.load_wav_batch([p], 800, [0], scale=1.0)
    assert out.shape == (1, 800) and np.all(out[0, 500:] == 0)
    np.testing.assert_allclose(out[0, :500], read_wav(p), atol=1e-6)
    np.testing.assert_array_equal(
        out, jax_native.load_wav_batch([p], 800, [0], scale=1.0))


def test_dataset_native_path_matches(tmp_path, lib):
    rng = np.random.default_rng(3)
    root, name, spk_ids = make_wav_dataset(str(tmp_path), rng, n_spks=2,
                                           utts_per_spk=2, length=3000)
    b1 = list(D.Dataset(spk_ids, root, name, wav_length=2000,
                        seed=7).batches(4, use_native=True))
    b2 = list(D.Dataset(spk_ids, root, name, wav_length=2000,
                        seed=7).batches(4, use_native=False))
    assert b1[0][0].shape == b2[0][0].shape == (4, 1, 2000)
    np.testing.assert_array_equal(b1[0][1], b2[0][1])
    # same scale domain (origin), the same crops
    assert np.abs(b1[0][0]).max() > 2 and np.abs(b2[0][0]).max() > 2
    np.testing.assert_allclose(b1[0][0], b2[0][0], atol=1e-6 * 32768)
    _equal_batches(b1, list(jax_dataset.Dataset(
        spk_ids, root, name, wav_length=2000, seed=7).batches(4)))


class _FakeResp(io.BytesIO):
    def __init__(self, data, ctype):
        super().__init__(data)
        self.headers = {"Content-Type": ctype}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_gdrive_download_confirm_flow(tmp_path):
    """The Google Drive interstitial: the port's fetch extracts the form
    fields and re-requests as JAX's does (the opener is faked)."""
    payload = b"\x1f\x8b-not-really-a-tarball-but-binary"
    interstitial = (
        '<html><body><form id="download-form" '
        'action="https://drive.usercontent.google.com/download" '
        'method="get">'
        '<input type="hidden" name="id" value="FILEID123"/>'
        '<input type="hidden" name="export" value="download"/>'
        '<input type="hidden" name="confirm" value="t"/>'
        '<input type="hidden" name="uuid" value="abc-def"/>'
        '<input type="submit" value="Download anyway"/>'
        "</form></body></html>")

    def run(fetch, dest):
        seen = []

        class FakeOpener:
            def open(self, url):
                seen.append(url)
                if "drive.usercontent.google.com" in url:
                    return _FakeResp(payload, "application/octet-stream")
                return _FakeResp(interstitial.encode(),
                                 "text/html; charset=utf-8")

        fetch("FILEID123", dest, opener=FakeOpener())
        assert open(dest, "rb").read() == payload
        return seen

    seen = run(D.gdrive_download, str(tmp_path / "port.tar.gz"))
    assert len(seen) == 2
    assert "id=FILEID123" in seen[1] and "uuid=abc-def" in seen[1] \
        and "confirm=t" in seen[1]
    assert seen == run(jax_dataset.gdrive_download,
                       str(tmp_path / "jax.tar.gz"))


def test_gdrive_download_direct_payload(tmp_path):
    class FakeOpener:
        def open(self, url):
            return _FakeResp(b"direct-bytes", "application/x-gzip")

    dest = str(tmp_path / "out2.tar.gz")
    D.gdrive_download("X", dest, opener=FakeOpener())
    assert open(dest, "rb").read() == b"direct-bytes"


def test_dataset_auto_download(tmp_path, monkeypatch, rng):
    """SPEAKERGUARD_DOWNLOAD=1 fetches and untars a named dataset (the
    fetch faked); by default the constructor raises the actionable
    FileNotFoundError, with JAX's message."""
    src = tmp_path / "stage" / "Spk10_test" / "spk0"
    src.mkdir(parents=True)
    write_wav(str(src / "a.wav"),
              (rng.standard_normal(4000) * 0.1).astype(np.float32))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        tf.add(str(tmp_path / "stage" / "Spk10_test"), arcname="Spk10_test")

    def fake_gdrive(file_id, path, opener=None):
        assert file_id == D._GDRIVE_IDS["Spk10_test"]
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return path

    monkeypatch.setattr(D, "gdrive_download", fake_gdrive)
    root = str(tmp_path / "data")
    with pytest.raises(FileNotFoundError, match="SPEAKERGUARD_DOWNLOAD") \
            as got:
        D.Spk10_test(["spk0"], root)
    with pytest.raises(FileNotFoundError) as want:
        jax_dataset.Spk10_test(["spk0"], root)
    assert str(got.value) == str(want.value)

    monkeypatch.setenv("SPEAKERGUARD_DOWNLOAD", "1")
    ds = D.Spk10_test(["spk0"], root)
    assert len(ds) == 1
    wav, label = ds[0]
    assert label == 0 and wav.shape == (1, 4000)
    np.testing.assert_array_equal(
        wav, jax_dataset.Spk10_test(["spk0"], root)[0][0])


def test_named_datasets_pin_the_domain(wav_root, tmp_path):
    """Spk10_* read the int16 origin domain, Spk251_* the [-1, 1) scale,
    as JAX's subclasses do."""
    root, name, spk_ids = wav_root
    for cls in ("Spk10_enroll", "Spk10_test", "Spk10_imposter",
                "Spk251_train", "Spk251_test"):
        os.symlink(os.path.join(root, name), str(tmp_path / cls))
        ds = getattr(D, cls)(spk_ids, root=str(tmp_path), wav_length=4000)
        jds = getattr(jax_dataset, cls)(spk_ids, root=str(tmp_path),
                                        wav_length=4000)
        assert type(ds).__name__ == cls
        assert (ds.normalize, ds.bits, ds.domain) == (
            jds.normalize, jds.bits, jds.domain)
        np.testing.assert_array_equal(ds[0][0], jds[0][0])
