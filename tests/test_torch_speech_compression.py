"""The port's speech-compression defenses (defenses/speech_compression.py,
ops/adpcm.py) against the JAX package's, on the same numpy inputs.

Bars:

- MULAW within rtol 1e-6 of JAX's op-by-op (eager) result: log1p and pow
  differ by an ulp between the frameworks, and no level flips at these
  sizes.  XLA's fused pow under ``jit`` differs more, up to 1.6e-5 of the
  smallest outputs, where ``256 ** |q| - 1`` cancels; its straight-through
  gradient exactly 1;
- ADPCM: ``adpcm_plain`` (the plain loop the CPU runs) ``torch.equal`` to
  JAX's scan, on uniform noise, on a speech-like wave, on origin-domain
  input (the batch-wide scale sniff) and at 3 and 5 bits;
- the seven ffmpeg codecs exactly equal to JAX's, both packages calling
  the deterministic stand-in ffmpeg of tests/test_speech_compression.py
  (it quantises to 512-step levels and pads each decoded wave by codec, so
  the start hints and the min-L1 search have work; here it prepends 2048
  samples to AAC, the encoder delay AAC's start hint cuts, where its 11
  would leave both packages an empty slice): the thread pool,
  origin-domain input, AMR's validation and the BPDA gradient;
- the kernel (``cuda``, skipped without a card) ``torch.equal`` to the
  plain loop on the card.
"""

import ctypes
import os
import re
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.defenses import speech_compression as JSC
from speakerguard_tpu.models.defended import DefendedModel as JaxDefended
from speakerguard_tpu.defenses.registry import parser_defense as jax_parser

from speakerguard_tpu_torch.defenses import speech_compression as SC
from speakerguard_tpu_torch.defenses.registry import parser_defense
from speakerguard_tpu_torch.models.defended import DefendedModel
from speakerguard_tpu_torch.ops import adpcm as A

from test_speech_compression import FAKE_FFMPEG, _roundtrip_expected
from test_torch_kenan import one_cpu_thread  # noqa: F401

CSRC = Path(A.__file__).resolve().parent.parent / "csrc"
HOST_CODECS = [("OPUS", 16000), ("SPEEX", 43200), ("AMR", 6600),
               ("AAC_V", 5), ("AAC_C", 20000), ("MP3_V", 9),
               ("MP3_C", 16000)]


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """The stand-in ffmpeg first on PATH, for both packages."""
    path = tmp_path / "ffmpeg"
    script = FAKE_FFMPEG.replace('"aac": 11', '"aac": 2048')
    assert script != FAKE_FFMPEG
    path.write_text(script.format(python=sys.executable))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")
    assert SC.ffmpeg_available() and JSC.ffmpeg_available()
    return path


def _wave(seed, shape, lo=-0.5, hi=0.5):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _grad_of_sum(fn, x):
    xt = torch.tensor(x, requires_grad=True)
    fn(xt).sum().backward()
    return xt.grad.numpy()


# ---- MULAW -----------------------------------------------------------------

@pytest.mark.parametrize("domain", ["scale", "origin"])
def test_mulaw_matches_jax(domain):
    x = _wave(0, (3, 2000), -0.9, 0.9)
    if domain == "origin":
        x = x * 32768.0
    want = np.asarray(JSC.MULAW(jnp.asarray(x), 255))
    got = SC.MULAW(torch.tensor(x), 255).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_grad_of_sum(lambda v: SC.MULAW(v, 255),
                                               x), 1.0)


# ---- ADPCM -----------------------------------------------------------------

def _speech(n=4000):
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 300 * t)
            + 0.1 * np.sin(2 * np.pi * 1700 * t)).astype(np.float32)[None]


ADPCM_CASES = {
    "noise": (lambda: _wave(1, (2, 300)), 4),
    "speech": (_speech, 4),
    "origin": (lambda: _wave(2, (2, 300)) * 32768.0, 4),
    "bits3": (lambda: _wave(3, (2, 300)), 3),
    "bits5": (lambda: _wave(4, (2, 300)), 5),
}


@pytest.mark.parametrize("case", sorted(ADPCM_CASES))
def test_adpcm_plain_equals_jax(case):
    make, bits = ADPCM_CASES[case]
    x = make()
    want = np.asarray(jax.jit(lambda v: JSC.ADPCM(v, bits))(jnp.asarray(x)))
    A.adpcm.reset_counts()
    got = SC.ADPCM(torch.tensor(x), bits)
    assert (A.adpcm.plain_calls, A.adpcm.launches) == (1, 0)
    assert torch.equal(got, torch.tensor(want))
    # the int16-domain samples through the plain loop directly
    x16 = np.clip(x * (1.0 if case == "origin" else 32768.0), -32768,
                  32767).astype(np.float32)
    np.testing.assert_array_equal(
        A.adpcm_plain(torch.tensor(x16), bits).numpy(),
        want * (1.0 if case == "origin" else 32768.0))


def test_adpcm_shapes_and_gradient():
    x = _wave(5, (2, 200))
    flat = SC.ADPCM(torch.tensor(x))
    assert torch.equal(SC.ADPCM(torch.tensor(x[:, None, :]))[:, 0], flat)
    assert torch.equal(SC.ADPCM(torch.tensor(x[0]))[None], flat[:1])
    np.testing.assert_array_equal(_grad_of_sum(SC.ADPCM, x), 1.0)
    with pytest.raises(ValueError, match="bits"):
        A.adpcm(torch.zeros(1, 4), bits=1)


def _c_declarations():
    src = (CSRC / "adpcm.cu").read_text()
    return {name: [a.strip() for a in args.split(",") if a.strip()]
            for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                         src)}


@pytest.mark.parametrize("name", sorted(A.ARGTYPES))
def test_adpcm_ctypes_signatures_match_the_source(name):
    decls = _c_declarations()
    assert set(decls) == set(A.ARGTYPES)
    c_args, py_args = decls[name], A.ARGTYPES[name]
    assert len(c_args) == len(py_args), (c_args, py_args)
    for c, t in zip(c_args, py_args):
        if "*" in c:
            assert t is ctypes.c_void_p, (name, c)
        else:
            assert re.fullmatch(r"int \w+", c), (name, c)
            assert t is ctypes.c_int, (name, c)


def test_adpcm_tables_match_the_source():
    src = (CSRC / "adpcm.cu").read_text()
    body = re.search(r"c_steps\[N_STEPS\] = \{([^}]*)\}", src).group(1)
    steps = [float(v) for v in body.replace("\n", " ").split(",")]
    np.testing.assert_array_equal(steps, A.IMA_STEPS)
    np.testing.assert_array_equal(A.IMA_STEPS, JSC._IMA_STEPS)
    adj = re.search(r"c_adj\[8\] = \{([^}]*)\}", src).group(1)
    np.testing.assert_array_equal([float(v) for v in adj.split(",")],
                                  A.IMA_INDEX_ADJ)
    np.testing.assert_array_equal(A.IMA_INDEX_ADJ, JSC._IMA_INDEX_ADJ)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 1000), (64, 4800), (33, 7)])
def test_cuda_adpcm_kernel_equals_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x16 = torch.tensor(np.clip(_wave(6, shape, -0.6, 0.6) * 32768.0, -32768,
                               32767), device="cuda")
    A.adpcm.reset_counts()
    got = A.adpcm(x16, 4)
    torch.cuda.synchronize()
    assert A.adpcm.launches == 1 and A.adpcm.plain_calls == 0
    assert torch.equal(got, A.adpcm_plain(x16, 4))
    assert torch.equal(got.cpu(), A.adpcm_plain(x16.cpu(), 4))


# ---- the ffmpeg codecs -----------------------------------------------------

@pytest.mark.parametrize("name,param", HOST_CODECS)
def test_host_codec_equals_jax(fake_ffmpeg, name, param):
    """Batch 2 through the thread pool; the stand-in's per-codec padding
    exercises the start hint (OPUS, AAC, MP3) or the min-L1 search (SPEEX,
    AMR)."""
    x = _wave(7, (2, 1200))
    want = np.asarray(getattr(JSC, name)(jnp.asarray(x), param=param))
    got = getattr(SC, name)(torch.tensor(x), param=param)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), _roundtrip_expected(x),
                               atol=1e-4)


def test_host_codec_origin_domain_and_one_wave(fake_ffmpeg):
    x = _wave(8, (1, 2000)) * 32768.0
    want = np.asarray(JSC.AMR(jnp.asarray(x), param=6600))
    got = SC.AMR(torch.tensor(x), param=6600).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got / 32768.0,
                               _roundtrip_expected(x / 32768.0), atol=1e-4)
    # (B, 1, L) keeps its shape
    assert SC.OPUS(torch.tensor(x[:, None] / 32768.0), 16000).shape == (
        1, 1, 2000)


def test_host_codec_gradient_and_amr_validation(fake_ffmpeg):
    x = _wave(9, (2, 1500))
    np.testing.assert_array_equal(
        _grad_of_sum(lambda v: SC.OPUS(v, param=16000), x), 1.0)
    with pytest.raises(NotImplementedError):
        SC.AMR(torch.zeros((1, 100)), param=1234)
    with pytest.raises(NotImplementedError):
        SC.AMR(torch.zeros((1, 100)), param=6600, fs=44100)


def test_host_codec_without_ffmpeg_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not SC.ffmpeg_available()
    with pytest.raises(RuntimeError, match="ffmpeg"):
        SC.SPEEX(torch.zeros((1, 100)), param=43200)


# ---- through the defended model --------------------------------------------

def test_defended_adpcm_scores_match_jax():
    """ADPCM 4 @0 before small iv-PLDA (the weights of
    tests/test_torch_defended.py): the defended scores at its iv bar."""
    from test_torch_defended import SCORE_TOL, SPK
    from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
    from speakerguard_tpu.models.iv_plda import random_iv_plda_params
    from speakerguard_tpu_torch.convert import from_jax_params
    from speakerguard_tpu_torch.models.iv_plda import IvPlda
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=32, reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    jm = JaxIvPlda(params)
    pm = IvPlda(from_jax_params(jax.tree.map(np.asarray, params),
                                device="cpu"))
    jm.set_enrollment(SPK, enroll)
    pm.set_enrollment(SPK, enroll)
    args = (["ADPCM"], ["4"], [0], "sequential")
    jd, jname = jax_parser(*args)
    d, name = parser_defense(*args)
    assert name == jname == "ADPCM&4@0"
    x = _wave(10, (2, 8000), -0.2, 0.2)
    want = np.asarray(JaxDefended(jm, defense=jd).score(jnp.asarray(x)))
    with torch.no_grad():
        got = DefendedModel(pm, defense=d).score(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL["iv"])


def test_bench_adpcm_defense_entry_prints_one_result_line(capsys):
    """python -m speakerguard_tpu_torch.bench --defense ADPCM: the codec
    through the registry (its default 4 bits, flag 0) before the model."""
    import json
    from speakerguard_tpu_torch import bench
    assert bench.main(["--model", "audionet", "--defense", "ADPCM",
                       "--device", "cpu", "--batch", "2", "--wav-len",
                       "2000", "--iters", "1", "--warmup", "0",
                       "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "pgd1_audionet_ADPCM_utts_per_sec"
    assert rec["defense"] == "ADPCM" and rec["value"] > 0
