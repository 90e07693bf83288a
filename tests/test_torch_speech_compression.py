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
  input (the batch-wide scale sniff) and at 3 and 5 bits, the defense
  through ``adpcm.scaled``'s plain version; a numpy float32 mirror of the
  kernel's step (the closed-form coder where the kernel runs it, the
  five-candidate step select, the arithmetic index adjustment, an int
  index) ``array_equal`` to ``adpcm_plain`` for bits 2..16 on inputs that
  reach each edge of the recurrence (a remainder exactly on a threshold
  k*u, a remainder of twice the step or more, the predictor held at both
  clamps, the index held at 0 and at 88); the closed-form coder equal to
  the serial taps on every threshold and its neighbours through 10 bits,
  and shown to differ from them from 11 bits on;
- the seven ffmpeg codecs exactly equal to JAX's, both packages calling
  the deterministic stand-in ffmpeg of tests/test_speech_compression.py
  (it quantises to 512-step levels and pads each decoded wave by codec, so
  the start hints and the min-L1 search have work; here it prepends 2048
  samples to AAC, the encoder delay AAC's start hint cuts, where its 11
  would leave both packages an empty slice): the thread pool,
  origin-domain input, AMR's validation and the BPDA gradient;
- the kernel (``cuda``, skipped without a card) ``torch.equal`` to the
  plain loop on the card, for bits 2..16 on ragged and edge shapes and on
  the edge inputs, and the fused defense to the unfused composition.
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


def test_adpcm_closed_form_bits_match_the_source():
    src = (CSRC / "adpcm.cu").read_text()
    bits = int(re.search(r"kClosedMaxBits = (\d+);", src).group(1))
    assert bits == A.CLOSED_FORM_MAX_BITS


@pytest.mark.parametrize("domain", ["scale", "origin"])
def test_adpcm_scaled_plain_equals_the_composition(domain):
    """``adpcm.scaled``'s plain version: the defense's sniff, scaling and
    clamps around ``adpcm_plain``, as ``_to_scale`` composes them."""
    x = _wave(11, (3, 400), -0.7, 0.7) * (32768.0 if domain == "origin"
                                          else 1.0)
    xt = torch.tensor(x)
    scaled, restore = SC._to_scale(xt)
    x16 = torch.clamp(scaled * 32768.0, -32768.0, 32767.0)
    want = A.adpcm_plain(x16, 4) / 32768.0 * restore
    assert torch.equal(A.adpcm_scaled_plain(xt, 4), want)
    A.adpcm.reset_counts()
    assert torch.equal(A.adpcm.scaled(xt, 4), want)
    assert (A.adpcm.plain_calls, A.adpcm.launches) == (1, 0)


# ---- the kernel's step, mirrored in numpy ----------------------------------

F32 = np.float32
CAND_OFFSETS = np.array([-1, 2, 4, 6, 8])   # the five index moves


def _index_adjustment(c):
    """IMA_INDEX_ADJ[c] for c = min(code, 7), as the kernel computes it."""
    return np.where(c < 4, -1, 2 * (c - 3))


def _closed_coder(rem, neg, u, n):
    """code = #{k in 1..2^n-1 : rem >= k*u}, the 0/1 compares summed
    pairwise (the kernel's order); recon = code * (+-u) + (+-u/2), the
    product exact."""
    k_max = 2 ** n - 1
    a = (rem[:, None] >= u[:, None] * np.arange(1, k_max + 1, dtype=F32)
         ).astype(F32)
    w = 1
    while w < k_max:
        for i in range(0, k_max - w, 2 * w):
            a[:, i] = a[:, i] + a[:, i + w]
        w *= 2
    su = np.where(neg, -u, u)
    return a[:, 0].astype(np.int64), a[:, 0] * su + su * F32(0.5)


def _serial_coder(rem, neg, s, n):
    """The JAX body's bit-serial taps, the code an int."""
    code = np.zeros(rem.shape, np.int64)
    acc = np.zeros_like(rem)
    for _ in range(n):
        bit = rem >= s
        code = 2 * code + bit
        rem = np.where(bit, rem - s, rem)
        acc = acc + np.where(bit, s, F32(0))
        s = s * F32(0.5)
    recon = acc + s
    return code, np.where(neg, -recon, recon)


class _Mirror:
    """csrc/adpcm.cu's step in numpy float32 over (B,) waves: the closed-form
    coder for bits <= CLOSED_FORM_MAX_BITS (the code a sum of 0/1 compares,
    recon = code * (+-u) + (+-u/2)) and the serial taps above; the next
    step and index selected by ge[k] = [min(code, 7) >= k], k = 4..7, as the
    first of the five candidates plus the differences that ge selects (the
    table's rows, steps pre-scaled to u where the closed form runs); the
    index an int, carried as a float plus 2^23 and read back from its bits.
    ``hits`` counts the samples that reached each edge of the recurrence."""

    def __init__(self, b, bits):
        self.n = bits - 1
        self.closed = bits <= A.CLOSED_FORM_MAX_BITS
        self.to_u = F32(2.0 ** -(self.n - 1))
        scale = self.to_u if self.closed else F32(1)
        self.cand_idx = np.clip(np.arange(89)[:, None] + CAND_OFFSETS, 0, 88)
        cand_step = A.IMA_STEPS[self.cand_idx] * scale
        # each row: the first candidate, then the differences to the next
        self.step_words = np.diff(cand_step, axis=1, prepend=F32(0))
        self.idx_words = np.diff(self.cand_idx.astype(F32) + F32(2 ** 23),
                                 axis=1, prepend=F32(0))
        self.pred = np.zeros(b, F32)
        self.idx = np.zeros(b, np.int64)
        self.step = np.full(b, A.IMA_STEPS[0] * scale, F32)
        self.hits = {"on_threshold": 0, "rem_2s": 0, "pred_max": 0,
                     "pred_min": 0, "idx_0": 0, "idx_88": 0}

    @property
    def u(self):
        return self.step if self.closed else self.step * self.to_u

    def __call__(self, x):
        diff = x - self.pred
        neg, rem = diff < 0, np.abs(diff)
        u = self.u
        k = np.arange(1, 2 ** self.n, dtype=F32)
        self.hits["on_threshold"] += int(
            (rem[:, None] == u[:, None] * k).any(axis=1).sum())
        self.hits["rem_2s"] += int((rem >= 2 * (u * F32(2 ** (self.n - 1))))
                                   .sum())
        coder = _closed_coder if self.closed else _serial_coder
        code, recon = coder(rem, neg, self.step, self.n)
        self.pred = np.clip(self.pred + recon, F32(-32768), F32(32767))
        c = np.minimum(code, 7)
        ge = (c[:, None] >= np.arange(4, 8)).astype(F32)   # set in order
        ones = np.ones((len(c), 1), F32)
        sel = np.concatenate([ones, ge], axis=1)

        def pick(words):  # the first word plus the selected differences
            w = words[self.idx] * sel
            return (w[:, 0] + w[:, 1]) + (w[:, 2] + w[:, 3]) + w[:, 4]

        nxt = (pick(self.idx_words).view(np.int32) - 0x4B000000).astype(
            np.int64)
        slot = np.where(c < 4, 0, c - 3)
        assert (CAND_OFFSETS[slot] == _index_adjustment(c)).all()
        assert (nxt == self.cand_idx[self.idx, slot]).all()
        assert (nxt == np.clip(self.idx + _index_adjustment(c), 0, 88)).all()
        self.step = pick(self.step_words)
        self.idx = nxt
        for key, hit in (("pred_max", self.pred == 32767),
                         ("pred_min", self.pred == -32768),
                         ("idx_0", self.idx == 0), ("idx_88", self.idx == 88)):
            self.hits[key] += int(hit.sum())
        return self.pred


def _run_mirror(x16, bits):
    m = _Mirror(x16.shape[0], bits)
    out = np.stack([m(x16[:, t]) for t in range(x16.shape[1])], axis=1)
    return out, m.hits


def _edge_waves(bits, length=600, seed=12):
    """(6, length) int16-domain waves that reach the recurrence's edges:
    0 a full-scale square then silence (the index falls to 0 and stays);
    1 a full-scale square (the index rises to 88, remainders >= 2 steps);
    2 32767 then -32768 (the predictor held at both clamps); 3 each sample
    on a threshold, pred +- k*u for a random k (the state followed through
    the mirror); 4 jumps of +-20000; 5 uniform noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    square = np.where(t % 2 == 0, 32767.0, -32767.0)
    x = np.zeros((6, length), F32)
    x[0, :100] = square[:100]
    x[1] = square
    x[2, : length // 2], x[2, length // 2:] = 32767.0, -32768.0
    x[4] = np.where(rng.random(length) < 0.5, 20000.0, -20000.0)
    x[5] = rng.uniform(-30000, 30000, length)
    m = _Mirror(1, bits)
    k_max = 2 ** (bits - 1) - 1
    for i in range(length):
        pred, u = m.pred[0], m.u[0]
        k = F32(rng.integers(1, k_max + 1))
        while k > 1 and abs(pred) + k * u > 32767:
            k = F32(k // 2)
        x[3, i] = pred - k * u if pred > 0 else pred + k * u
        m(x[3, i:i + 1])
    return x


@pytest.mark.parametrize("bits", range(2, 17))
def test_adpcm_mirror_equals_plain_on_edge_inputs(bits):
    x16 = _edge_waves(bits)
    want = A.adpcm_plain(torch.tensor(x16), bits).numpy()
    got, hits = _run_mirror(x16, bits)
    np.testing.assert_array_equal(got, want)
    assert hits["rem_2s"] > 0 and hits["idx_0"] > 400
    if bits <= 10:   # pred +- k*u is exact where k*u is
        assert hits["on_threshold"] >= 500, hits
    if bits >= 4:    # 2 and 3 bits never raise the index
        assert min(hits["idx_88"], hits["pred_max"], hits["pred_min"]) > 0


@pytest.mark.parametrize("bits", range(2, 17))
def test_adpcm_closed_form_coder_exact_through_ten_bits(bits):
    """The closed-form coder against the serial taps on every threshold
    k*u, its two float neighbours, remainders of 2 steps and more, and 0:
    equal through 10 bits, where (2^n - 1) x the step's 15 bits fit in 24,
    over all 89 steps; from 11 bits on the thresholds round, and a
    remainder on a rounded-down threshold counts one code too many."""
    n = bits - 1
    k = np.arange(1, 2 ** n, dtype=F32)
    steps = A.IMA_STEPS if bits <= 10 else A.IMA_STEPS[-4:]
    differ = 0
    for step in steps:
        u = F32(step * F32(2.0 ** -(n - 1)))
        th = u * k
        rem = np.unique(np.concatenate([
            th, np.nextafter(th, F32(0)), np.nextafter(th, F32(np.inf)),
            F32(step) * np.array([2, 2.5, 3], F32), [F32(0), F32(65535)]]))
        neg = np.arange(rem.size) % 2 == 1
        want_code, want_recon = _serial_coder(
            rem, neg, np.full(rem.shape, F32(step)), n)
        code = np.searchsorted(th, rem, side="right")  # #{k : rem >= k*u}
        recon = code.astype(F32) * u + u * F32(0.5)
        recon = np.where(neg, -recon, recon)
        if bits <= 10:
            np.testing.assert_array_equal(code, want_code)
            np.testing.assert_array_equal(recon, want_recon)
            if bits <= A.CLOSED_FORM_MAX_BITS:   # and the kernel's order
                got_code, got_recon = _closed_coder(
                    rem, neg, np.full(rem.shape, u), n)
                np.testing.assert_array_equal(got_code, want_code)
                np.testing.assert_array_equal(got_recon, want_recon)
        differ += int((code != want_code).sum())
    assert (differ == 0) == (bits <= 10), differ


@pytest.mark.cuda
@pytest.mark.parametrize("bits", range(2, 17))
@pytest.mark.parametrize("shape", [(5, 1000), (64, 4800), (33, 7), (1, 1),
                                   (1, 300), (40, 65), (0, 10), (3, 0)])
def test_cuda_adpcm_kernel_equals_plain(shape, bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x16 = torch.tensor(np.clip(_wave(6, shape, -0.6, 0.6) * 32768.0, -32768,
                               32767), device="cuda")
    A.adpcm.reset_counts()
    got = A.adpcm(x16, bits)
    torch.cuda.synchronize()
    assert A.adpcm.launches == 1 and A.adpcm.plain_calls == 0
    assert got.shape == x16.shape
    assert torch.equal(got, A.adpcm_plain(x16, bits))
    assert torch.equal(got.cpu(), A.adpcm_plain(x16.cpu(), bits))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", range(2, 17))
def test_cuda_adpcm_kernel_equals_plain_on_edge_inputs(bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x16 = _edge_waves(bits)
    got = A.adpcm(torch.tensor(x16, device="cuda"), bits).cpu().numpy()
    np.testing.assert_array_equal(
        got, A.adpcm_plain(torch.tensor(x16), bits).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["scale", "origin"])
def test_cuda_adpcm_defense_fused_equals_the_composition(domain):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.tensor(_wave(13, (70, 3000), -0.7, 0.7)
                     * (32768.0 if domain == "origin" else 1.0),
                     device="cuda")
    scaled, restore = SC._to_scale(x)
    x16 = torch.clamp(scaled * 32768.0, -32768.0, 32767.0)
    want = A.adpcm(x16, 4) / 32768.0 * restore
    A.adpcm.reset_counts()
    got = SC.ADPCM(x, 4)
    torch.cuda.synchronize()
    assert A.adpcm.launches == 1 and A.adpcm.plain_calls == 0
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), A.adpcm_scaled_plain(x.cpu(), 4))


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
