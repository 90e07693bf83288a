"""The port's evaluation CLIs against the JAX package's, on one world:
enroll -> set_threshold -> specify_target_label -> attack_main ->
test_attack (speakerguard_tpu_torch/cli/ against speakerguard_tpu/cli/).

The world is tests/test_cli.py's (its ``world`` fixture: the small iv-PLDA
Kaldi artifacts of tests/fixtures.py, Spk10-style folders of 8000-sample
waves), with its ``small_mfcc`` patch on the JAX IvPlda and the same patch
mirrored on the port's.  Every case runs both CLIs, the port's with
``-device cpu``.  JAX's attack_main draws PGD's dither from
``fold_in(PRNGKey(seed), batch index)``; the port's draws from its own
generator unless told otherwise, so the cases that compare attacks wrap
the port's ``attack_main.make_attacker`` and hand JAX's draws to the
attacker's hooks (tests/test_torch_attack_draws.py's JaxPgdDraws).

Bars (each case names its own): embeddings rtol 1e-5, z-norm statistics
and thresholds 1e-4 relative, decisions, EER, IER, accuracies, targets and
per-sample success equal; written audio: at least 99% of the samples
within 2 int16 steps of JAX's and every sample within 2 epsilon;
imperceptibility means within 1e-9.
"""

import contextlib
import io
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from speakerguard_tpu.cli import attack_main as jax_attack_main
from speakerguard_tpu.cli import enroll as jax_enroll
from speakerguard_tpu.cli import set_threshold as jax_set_threshold
from speakerguard_tpu.cli import specify_target_label as jax_specify
from speakerguard_tpu.cli import test_attack as jax_test_attack
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import (
    load_iv_plda_params as jax_load_iv_plda_params)

from speakerguard_tpu_torch.cli import (attack_main, enroll, set_threshold,
                                        specify_target_label, test_attack)
from speakerguard_tpu_torch.cli.common import build_model
from speakerguard_tpu_torch.models.iv_plda import IvPlda, load_iv_plda_params
from speakerguard_tpu_torch.ops.kaldi_mfcc import MfccConfig
from speakerguard_tpu_torch.utils.audio_io import read_wav

from test_cli import _iv_args, small_mfcc, world  # noqa: F401
from test_torch_attack_draws import JaxPgdDraws
from test_torch_kenan import one_cpu_thread  # noqa: F401

LSB = 1.0 / 32768.0


@pytest.fixture(scope="module")
def port_small_mfcc():
    """test_cli.py's small_mfcc patch mirrored on the port's IvPlda."""
    import speakerguard_tpu_torch.models.iv_plda as ivm
    small = MfccConfig(num_ceps=8)
    orig_init = ivm.IvPlda.__init__

    def patched(self, params, model_file=None, threshold=None,
                mfcc_config=None, **kw):
        orig_init(self, params, model_file=model_file, threshold=threshold,
                  mfcc_config=small, **kw)
    ivm.IvPlda.__init__ = patched
    yield
    ivm.IvPlda.__init__ = orig_init


@pytest.fixture(scope="module")
def both(world, small_mfcc, port_small_mfcc):  # noqa: F811
    return world


def _jax(paths, extra):
    return _iv_args(paths, extra)


def _port(paths, extra):
    return _iv_args(paths, extra + ["-device", "cpu"])


def _quiet(fn, *args):
    """fn(*args) with its standard output captured: (result, output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def enrolled(both):
    """Each package's enroll run on the world: {package: model file}."""
    tmpdir, paths, data_root = both
    files = {}
    for tag, mod, argv in (("jax", jax_enroll, _jax), ("port", enroll,
                                                        _port)):
        model_dir = os.path.join(tmpdir, f"model_{tag}")
        _quiet(mod.main, mod.parse_args(argv(
            paths, ["-model_dir", model_dir, "-root", data_root])))
        files[tag] = os.path.join(model_dir, "iv_plda",
                                  "speaker_model_iv_plda")
    return files


def _index(path):
    return [line.split() for line in open(path).read().splitlines()]


def test_enroll_matches_jax(both, enrolled):
    """Embeddings within rtol 1e-5 (atol 1e-5 of their largest entry),
    z-norm mean and std within 1e-4 relative, the same index lines apart
    from the paths, one per-speaker file each; each package's model file
    loads in the other's IvPlda."""
    _, paths, _ = both
    jax_rows, port_rows = _index(enrolled["jax"]), _index(enrolled["port"])
    assert [r[0] for r in port_rows] == [r[0] for r in jax_rows] == [
        "spk0", "spk1", "spk2"]
    for j, p in zip(jax_rows, port_rows):
        want, got = np.load(j[1]), np.load(p[1])
        assert got.shape == want.shape == (1, 8)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(np.float64(p[2:]), np.float64(j[2:]),
                                   rtol=1e-4)
        assert os.path.basename(p[1]) == os.path.basename(j[1])
        per_spk = os.path.join(os.path.dirname(enrolled["port"]),
                               f"speaker_model_iv_plda_{p[0]}")
        assert _index(per_spk) == [p]

    files = [paths[k] for k in ("gmm", "extractor", "plda", "mean",
                                "transform")]
    port_in_jax = JaxIvPlda(jax_load_iv_plda_params(*files),
                            model_file=enrolled["port"])
    jax_in_port = IvPlda(load_iv_plda_params(*files, device="cpu"),
                         model_file=enrolled["jax"])
    assert port_in_jax.spk_ids == jax_in_port.spk_ids == ["spk0", "spk1",
                                                          "spk2"]
    np.testing.assert_array_equal(
        np.asarray(port_in_jax.enroll_embs),
        np.concatenate([np.load(r[1]) for r in port_rows]))
    np.testing.assert_array_equal(
        jax_in_port.enroll_embs.numpy(),
        np.concatenate([np.load(r[1]) for r in jax_rows]))


def test_set_threshold_matches_jax(both, enrolled):
    """The returned dicts: thresholds within 1e-4 relative; EER, IER and
    CSI accuracy equal."""
    _, paths, data_root = both
    want, _ = _quiet(jax_set_threshold.main, jax_set_threshold.parse_args(
        _jax(paths, ["-root", data_root]) + ["-model_file",
                                              enrolled["jax"]]))
    got, out = _quiet(set_threshold.main, set_threshold.parse_args(
        _port(paths, ["-root", data_root]) + ["-model_file",
                                               enrolled["port"]]))
    assert "SV" in out and "OSI" in out and "CSI ACC" in out
    assert got.keys() == want.keys()
    for k in ("sv_threshold", "osi_threshold"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for k in ("sv_eer", "osi_eer", "osi_ier", "csi_acc"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("mode", ["random", "hardest", "simplest"])
def test_specify_target_label_matches_jax(both, enrolled, mode):
    """The pickles are equal."""
    tmpdir, paths, data_root = both
    flags = [] if mode == "random" else [f"-{mode}"]
    pickles = {}
    for tag, mod, argv in (("jax", jax_specify, _jax),
                           ("port", specify_target_label, _port)):
        save = os.path.join(tmpdir, f"targets_{mode}_{tag}.pkl")
        _quiet(mod.main, mod.parse_args(argv(
            paths, ["-root", data_root, "-name", "Spk10_test", "-save_path",
                    save] + flags) + ["-model_file", enrolled[tag]]))
        with open(save, "rb") as f:
            pickles[tag] = pickle.load(f)
    assert len(pickles["jax"]) == 6
    assert pickles["port"] == pickles["jax"]


def _recording(monkeypatch, module, jax_draws):
    """Wrap ``module.make_attacker`` so that each attack call's success list
    is recorded; with ``jax_draws`` (the port) each batch's attacker gets
    JAX's draws for that batch, the k-th call of a fresh run being batch
    ``start + k``."""
    record = []
    orig = module.make_attacker

    def make(args, model):
        atk = orig(args, model)
        attack = atk.attack

        def attack_rec(x, y, rng=None):
            if jax_draws:
                key = jax.random.fold_in(jax.random.PRNGKey(args.seed),
                                         args.start + len(record))
                draws = JaxPgdDraws(key, atk.epsilon, atk.max_iter,
                                    atk.EOT_size, atk.num_random_init)
                atk.init_noise_fn = draws.init_noise_fn
                atk.dither_fn = draws.dither_fn
            adver, success = attack(x, y, rng=rng)
            record.append([bool(s) for s in success])
            return adver, success
        atk.attack = attack_rec
        return atk
    monkeypatch.setattr(module, "make_attacker", make)
    return record


def _attack_both(tmpdir, paths, data_root, enrolled, name, extra, attack):
    """Both CLIs' attack_main into <tmpdir>/<name>_<package>: {package:
    (directory, per-batch success lists, output)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, mod, argv in (("jax", jax_attack_main, _jax),
                               ("port", attack_main, _port)):
            des = os.path.join(tmpdir, f"{name}_{tag}")
            record = _recording(mp, mod, tag == "port")
            _, text = _quiet(mod.main, mod.parse_args(argv(
                paths, ["-root", data_root, "-name", "Spk10_test", "-des",
                        des, "-batch_size", "2", "-wav_length", "8000"]
                + extra) + ["-model_file", enrolled[tag]] + attack))
            out[tag] = (des, record, text)
    return out


@pytest.fixture(scope="module")
def pgd_default(both, enrolled):
    """attack_main PGD at the CLI's defaults (10 iterations, eps 0.002,
    step 0.0004, every score dithered) in both packages."""
    tmpdir, paths, data_root = both
    return _attack_both(tmpdir, paths, data_root, enrolled, "adver_pgd", [],
                        ["PGD"])


def _wavs(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs
                  if f.endswith(".wav"))


def _rate(text):
    return float(re.search(r"success rate: ([0-9.]+)", text).group(1))


def _audio_agreement(runs, epsilon):
    """The share of samples within 2 int16 steps of JAX's over the written
    tree (asserting the same tree and every sample within 2 epsilon)."""
    (jdir, _, _), (pdir, _, _) = runs["jax"], runs["port"]
    names = _wavs(jdir)
    assert names and _wavs(pdir) == names
    close = total = 0
    for rel in names:
        want = read_wav(os.path.join(jdir, rel))
        got = read_wav(os.path.join(pdir, rel))
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.max() <= 2 * epsilon + 2 * LSB, rel
        close += int((diff <= 2 * LSB).sum())
        total += diff.size
    return close / total


def test_attack_main_pgd_matches_jax(pgd_default):
    """PGD at the CLI's defaults with JAX's draws passed in: the same
    per-sample success, printed rate and directory tree, and the written
    audio at the bar.  A sign step can flip where the gradient is near
    zero, hence the 99%: measured 99.87% of the samples within 2 int16
    steps, against 97.49% with the port's own draws."""
    assert pgd_default["port"][1] == pgd_default["jax"][1]
    assert len(pgd_default["port"][1]) == 3
    assert _rate(pgd_default["port"][2]) == _rate(pgd_default["jax"][2])
    assert _audio_agreement(pgd_default, 0.002) >= 0.99


def test_attack_main_resumes_by_skip(both, enrolled, pgd_default):
    """A second run into the same directory skips every batch, as JAX's
    does, and leaves the files as they were."""
    _, paths, data_root = both
    for tag, mod, argv in (("jax", jax_attack_main, _jax),
                           ("port", attack_main, _port)):
        des = pgd_default[tag][0]
        before = {rel: open(os.path.join(des, rel), "rb").read()
                  for rel in _wavs(des)}
        result, text = _quiet(mod.main, mod.parse_args(argv(
            paths, ["-root", data_root, "-name", "Spk10_test", "-des", des,
                    "-batch_size", "2", "-wav_length", "8000"])
            + ["-model_file", enrolled[tag], "PGD"]))
        assert text.count("Exists, Skip") == 3, tag
        assert "success rate" not in text
        assert {rel: open(os.path.join(des, rel), "rb").read()
                for rel in _wavs(des)} == before
        if tag == "port":
            assert result["success"] == {} and result["success_rate"] is None


def _test_attack_both(paths, enrolled, adver_dir, extra):
    """Both CLIs' test_attack on JAX's adversarial directory: {package:
    (output, imperceptibility rows or means)}.  JAX's rows are read by
    wrapping its get_all_metric."""
    rows = []
    argv = ["-root", os.path.dirname(adver_dir), "-name",
            os.path.basename(adver_dir)] + extra
    with pytest.MonkeyPatch.context() as mp:
        orig = jax_test_attack.get_all_metric
        mp.setattr(jax_test_attack, "get_all_metric",
                   lambda b, a: rows.append(orig(b, a)) or rows[-1])
        _, jtext = _quiet(jax_test_attack.main, jax_test_attack.parse_args(
            _jax(paths, argv) + ["-model_file", enrolled["jax"]]))
    got, ptext = _quiet(test_attack.main, test_attack.parse_args(
        _port(paths, argv) + ["-model_file", enrolled["port"]]))
    return (jtext, rows), (ptext, got)


def _printed(text, what):
    return float(re.search(what + r":? ([-0-9.e]+)", text).group(1))


def test_test_attack_matches_jax(both, enrolled, pgd_default):
    """On JAX's adversarial directory, with the originals: accuracy and
    untargeted ASR equal to JAX's; the imperceptibility means (L2, L0, L1,
    Linf, SNR, PESQ, STOI over the finite-SNR utterances) within 1e-9 of
    the means of JAX's rows."""
    _, paths, data_root = both
    (jtext, rows), (ptext, got) = _test_attack_both(
        paths, enrolled, pgd_default["jax"][0],
        ["-root_ori", data_root, "-name_ori", "Spk10_test"])
    for what in ("Acc", "Untargeted Attack Success Rate"):
        assert _printed(ptext, what) == _printed(jtext, what), what
    assert got["acc"] == _printed(jtext, "Acc")
    rows = [r for r in rows if r[4] != np.inf]
    assert len(rows) == 6
    want = np.mean(np.array(rows, dtype=np.float64), axis=0)
    np.testing.assert_allclose(got["imperceptibility"], want, rtol=1e-9)
    line = re.search(r"L2, SNR, PESQ, STOI: .*", ptext).group(0)
    assert line == re.search(r"L2, SNR, PESQ, STOI: .*", jtext).group(0)


def test_targeted_attack_via_label_file_matches_jax(both, enrolled):
    """tests/test_cli.py's targeted flow in both packages: everyone
    targets speaker 0 (speaker 1 for spk0) through a label file, PGD-3 with
    JAX's draws; the same per-sample success and printed rate, the rate
    equal to a re-decision of the port's written audio; then test_attack
    -target_label_file on JAX's directory: the same accuracy and targeted
    ASR in both."""
    tmpdir, paths, data_root = both
    save_path = os.path.join(tmpdir, "targets_fixed_both.pkl")
    name2target = {}
    for spk in sorted(os.listdir(os.path.join(data_root, "Spk10_test"))):
        for f in sorted(os.listdir(os.path.join(data_root, "Spk10_test",
                                                spk))):
            name2target[os.path.splitext(f)[0]] = 1 if spk == "spk0" else 0
    with open(save_path, "wb") as fh:
        pickle.dump(name2target, fh)
    runs = _attack_both(tmpdir, paths, data_root, enrolled,
                        "adver_targeted",
                        ["-targeted", "-target_label_file", save_path],
                        ["PGD", "-max_iter", "3", "-epsilon", "0.02",
                         "-step_size", "0.01"])
    assert runs["port"][1] == runs["jax"][1]
    rate = _rate(runs["port"][2])
    assert rate == _rate(runs["jax"][2])

    args = attack_main.parse_args(_port(paths, [
        "-root", data_root, "-name", "Spk10_test"]) + [
        "-model_file", enrolled["port"], "PGD"])
    base, model, _ = build_model(args)
    hits = []
    for rel in _wavs(runs["port"][0]):
        name = os.path.splitext(os.path.basename(rel))[0]
        adv = read_wav(os.path.join(runs["port"][0], rel))[None]
        with torch.no_grad():
            decision = int(model.make_decision(torch.tensor(adv))[0][0])
        hits.append(decision == name2target[name])
    assert len(hits) == 6
    assert abs(rate - 100.0 * sum(hits) / len(hits)) < 1e-6

    (jtext, _), (ptext, got) = _test_attack_both(
        paths, enrolled, runs["jax"][0], ["-target_label_file", save_path])
    for what in ("Acc", "Targeted Attack Success Rate"):
        assert _printed(ptext, what) == _printed(jtext, what), what
    assert got["targeted_asr"] == _printed(jtext,
                                           "Targeted Attack Success Rate")


def test_audionet_fgsm_cli_matches_jax(both, tmp_path):
    """tests/test_cli.py's AudioNet case in both packages: FGSM on CSI-NE
    from a reference state dict and label encoder; the same per-sample
    success and tree, the audio at the bar."""
    from test_networks import TorchAudioNet
    _, _, data_root = both
    torch.manual_seed(3)
    net = TorchAudioNet(num_class=3)
    ckpt = str(tmp_path / "audionet.ckpt")
    torch.save(net.state_dict(), ckpt)
    enc = str(tmp_path / "label_enc.txt")
    with open(enc, "w") as f:
        for i in range(3):
            f.write(f"'spk{i}' {i}\n")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, mod, dev in (("jax", jax_attack_main, []),
                              ("port", attack_main, ["-device", "cpu"])):
            des = str(tmp_path / f"adver_an_{tag}")
            record = _recording(mp, mod, False)
            _, text = _quiet(mod.main, mod.parse_args([
                "-root", data_root, "-name", "Spk10_test", "-des", des,
                "-batch_size", "2", "-wav_length", "8000", "-task", "CSI"]
                + dev + ["audionet_csine", "-extractor", ckpt,
                         "-label_encoder", enc, "FGSM", "-epsilon",
                         "0.01"]))
            assert "success rate" in text
            runs[tag] = (des, record, text)
    assert runs["port"][1] == runs["jax"][1]
    assert len(_wavs(runs["port"][0])) == 6
    assert _audio_agreement(runs, 0.01) >= 0.99


def test_origin_domain_input_rejected(both, enrolled):
    """tests/test_cli.py's domain guard on the port: origin-domain
    (int16-valued float) audio fed to an attack raises."""
    from speakerguard_tpu_torch.attacks import PGD
    _, paths, data_root = both
    args = attack_main.parse_args(_port(paths, [
        "-root", data_root, "-name", "Spk10_test"]) + [
        "-model_file", enrolled["port"], "PGD", "-max_iter", "1"])
    _, model, _ = build_model(args)
    origin_domain = np.random.default_rng(0).integers(
        -2000, 2000, size=(1, 8000)).astype(np.float32)
    with pytest.raises(ValueError, match="scale-domain"):
        PGD(model, task="CSI", epsilon=0.002, max_iter=1).attack(
            origin_domain, np.array([0]), rng=0)


def test_n_devices_above_one_raises(both, enrolled, tmp_path, monkeypatch):
    """-n_devices 2 raises, and writes nothing, where it cannot run: on
    cuda with fewer than 2 cards visible, and under torchrun with another
    world size."""
    _, paths, data_root = both
    des = str(tmp_path / "adver_mesh")
    argv = ["-root", data_root, "-name", "Spk10_test", "-des", des,
            "-n_devices", "2"]
    args = attack_main.parse_args(_iv_args(paths, argv) + [
        "-model_file", enrolled["port"], "PGD"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        _quiet(attack_main.main, args)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    args = attack_main.parse_args(_port(paths, argv) + [
        "-model_file", enrolled["port"], "PGD"])
    with pytest.raises(ValueError, match="torchrun world of 3"):
        _quiet(attack_main.main, args)
    assert not os.path.exists(des)


@pytest.fixture(scope="module")
def xv_world(both, tmp_path_factory):
    """An xv-PLDA system on the same waves: a random TDNN in the
    reference checkpoint's layout, Kaldi text PLDA, mean and LDA files
    (tests/test_torch_xv_plda.py's), enrolled by the port's enroll.
    Returns the xv_plda arguments with the model file."""
    from fixtures import write_mean_vec, write_plda_txt, write_transform_txt
    from test_torch_tdnn import _reference_state
    _, _, data_root = both
    d = tmp_path_factory.mktemp("xv_cli")
    rng = np.random.default_rng(31)
    r = 20
    q, _ = np.linalg.qr(rng.standard_normal((r, r)))
    write_plda_txt(d / "plda.txt", rng.standard_normal(r) * 0.1, q,
                   np.abs(rng.standard_normal(r)) + 0.5)
    write_mean_vec(d / "mean.vec", rng.standard_normal(512) * 0.1)
    write_transform_txt(d / "transform.txt",
                        rng.standard_normal((r, 513)) * 0.05)
    torch.save({k: torch.tensor(v) for k, v in _reference_state(rng).items()},
               d / "extractor.pt")
    system = ["xv_plda", "-extractor", str(d / "extractor.pt"), "-plda",
              str(d / "plda.txt"), "-mean", str(d / "mean.vec"),
              "-transform", str(d / "transform.txt")]
    _quiet(enroll.main, enroll.parse_args(
        ["-model_dir", str(d / "model"), "-root", data_root, "-device",
         "cpu"] + system))
    return system + ["-model_file", str(d / "model" / "xv_plda" /
                                        "speaker_model_xv_plda")]


@pytest.mark.parametrize("system", ["iv", "xv"])
def test_attack_main_two_ranks_equal_one(system, both, enrolled, request,
                                         tmp_path, capfd):
    """attack_main PGD at the CLI's defaults (every score dithered) with
    -n_devices 2 on the CPU (two spawned ranks under gloo, each batch of 2
    split over them) against -n_devices 1, on this file's iv-PLDA world
    and on xv-PLDA over the same waves: the same printed success rate and
    per-utterance success, the same tree of waves, every sample within 2
    epsilon.  Neither system's audio can be held to the in-process bars
    of tests/test_torch_parallel.py: each scores a batch of 1 and one of 2
    at ULP distance (xv: 3.05e-5 on scores in the hundreds, on every
    split), and a sign step turns that into whole-step moves where a
    gradient entry is near zero.  iv is held to tests/test_parallel.py's
    iv contract (at most 1e-3 of the samples beyond 2 int16 steps); on
    xv, over ten steps, the flips spread (measured: 1,345 of 48,000
    samples beyond 2 int16 steps, all in rank 1's rows, 1,212 in one
    wave), so only the 2-epsilon bound holds there."""
    _, paths, data_root = both
    if system == "iv":
        model = _iv_args(paths, []) + ["-model_file", enrolled["port"]]
    else:
        model = request.getfixturevalue("xv_world")
    runs = {}
    for n in ("1", "2"):
        des = str(tmp_path / f"adver_n{n}")
        args = attack_main.parse_args(
            ["-root", data_root, "-name", "Spk10_test", "-des", des,
             "-batch_size", "2", "-wav_length", "8000", "-n_devices", n,
             "-device", "cpu"] + model + ["PGD"])
        # the spawned ranks print to the file descriptor, not sys.stdout
        capfd.readouterr()
        result = attack_main.main(args)
        runs[n] = (des, result, capfd.readouterr().out)
    (d1, r1, t1), (d2, r2, t2) = runs["1"], runs["2"]
    assert r2["success"] == r1["success"] and len(r1["success"]) == 6
    assert _rate(t2) == _rate(t1) == r2["success_rate"]
    assert t2.count("success rate") == 1   # rank 0 alone prints
    names = _wavs(d1)
    assert names and _wavs(d2) == names
    far = total = 0
    for rel in names:
        a, b = read_wav(os.path.join(d1, rel)), read_wav(os.path.join(d2, rel))
        assert a.shape == b.shape
        diff = np.abs(a - b)
        assert diff.max() <= 2 * 0.002 + 2 * LSB, rel
        far += int((diff > 2 * LSB).sum())
        total += diff.size
    if system == "iv":
        assert far <= 1e-3 * total, far


def test_cli_without_a_card_raises(both, monkeypatch):
    """Without a CUDA device and without -device cpu a port CLI raises; it
    does not run on the CPU."""
    tmpdir, paths, data_root = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = enroll.parse_args(_iv_args(paths, [
        "-model_dir", os.path.join(tmpdir, "model_nocard"), "-root",
        data_root]))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="-device cpu"):
        enroll.main(args)
    assert not os.path.exists(os.path.join(tmpdir, "model_nocard"))


@pytest.mark.parametrize("name", ["enroll", "set_threshold",
                                  "specify_target_label", "attack_main",
                                  "test_attack"])
def test_cli_runs_as_a_module(name):
    """python -m speakerguard_tpu_torch.cli.<name> -h prints the grammar,
    -device included."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", f"speakerguard_tpu_torch.cli.{name}", "-h"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "-device" in out.stdout and "iv_plda" in out.stdout
