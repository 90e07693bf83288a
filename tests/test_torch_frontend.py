"""The port's Kaldi frontend (MFCC -> deltas -> sliding CMVN) against the
JAX package, in value and input gradient, and against the checked-in
float64 golden vectors that tests/test_frontend.py uses."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.ops import cmvn as jax_cmvn
from speakerguard_tpu.ops import delta as jax_delta
from speakerguard_tpu.ops import kaldi_mfcc as jax_mfcc

from speakerguard_tpu_torch.ops.cmvn import sliding_cmvn, window_bounds
from speakerguard_tpu_torch.ops.delta import add_delta
from speakerguard_tpu_torch.ops.kaldi_mfcc import (IV_PLDA_MFCC, XV_PLDA_MFCC,
                                                   kaldi_mfcc)

from test_torch_mfcc_fast import CONFIGS, _case, _mirror, _rel, _value_and_grad


def _golden():
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "kaldi_frontend_golden.npz")
    return np.load(path)


def _wavs(seed, b=2, length=8000):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 0.3, (b, length)) * 32768).astype(np.float32)


@pytest.mark.parametrize("cfg_name", ["IV_PLDA_MFCC", "XV_PLDA_MFCC"])
def test_mfcc_value_matches_jax(cfg_name):
    cfg = {"IV_PLDA_MFCC": IV_PLDA_MFCC, "XV_PLDA_MFCC": XV_PLDA_MFCC}[cfg_name]
    wavs = _wavs(1)
    want = np.asarray(jax_mfcc.kaldi_mfcc(jnp.asarray(wavs),
                                          getattr(jax_mfcc, cfg_name)))
    got = kaldi_mfcc(torch.tensor(wavs), cfg).numpy()
    assert got.shape == want.shape
    # both f32 with the same float64-precomputed DFT matrices; the sums
    # run in another order.  Broadband MFCCs reach |x| ~ 1e2.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("length", [8000, 6401])
def test_frontend_chain_value_and_grad_match_jax(length):
    """MFCC -> delta -> CMVN; the input gradient goes through the JAX
    package's hand-written framing and DFT-power VJPs on one side and
    plain torch autograd on the other."""
    wavs = _wavs(2, length=length)
    cot = np.random.default_rng(3).standard_normal(
        np.asarray(jax_mfcc.kaldi_mfcc(jnp.asarray(wavs))).shape[:2]
        + (72,)).astype(np.float32)

    def jchain(w):
        return jax_cmvn.sliding_cmvn(
            jax_delta.add_delta(jax_mfcc.kaldi_mfcc(w)))

    want = np.asarray(jchain(jnp.asarray(wavs)))
    want_g = np.asarray(jax.grad(lambda w: jnp.sum(jchain(w) * cot))(
        jnp.asarray(wavs)))
    x = torch.tensor(wavs, requires_grad=True)
    got = sliding_cmvn(add_delta(kaldi_mfcc(x)))
    (got * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=5e-4)
    g, wg = x.grad.numpy(), want_g
    # gradient: ~1e-5 relative to its own scale (f32 sums of O(1e3) terms)
    np.testing.assert_allclose(g, wg, rtol=1e-3,
                               atol=1e-4 * np.abs(wg).max())


def test_mfcc_dither_uses_generator():
    wavs = torch.tensor(_wavs(4))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a = kaldi_mfcc(wavs, IV_PLDA_MFCC, rng=g1)
    b = kaldi_mfcc(wavs, IV_PLDA_MFCC, rng=g2)
    c = kaldi_mfcc(wavs, IV_PLDA_MFCC)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_mfcc_matches_golden_broadband():
    """Same bar as test_frontend.py::test_mfcc_matches_golden_broadband."""
    g = _golden()
    wav = torch.tensor(g["noise_wav"], dtype=torch.float32)[None]
    np.testing.assert_allclose(kaldi_mfcc(wav, IV_PLDA_MFCC)[0].numpy(),
                               g["noise_mfcc24"], rtol=1e-4, atol=1.5e-3)
    np.testing.assert_allclose(kaldi_mfcc(wav, XV_PLDA_MFCC)[0].numpy(),
                               g["noise_mfcc30"], rtol=1e-4, atol=1.5e-3)


@pytest.mark.parametrize("name", ["sweep", "voiced"])
def test_mfcc_matches_golden_tonal(name):
    """Same bar as test_frontend.py::test_mfcc_matches_golden_tonal: tonal
    inputs drive off-harmonic mel bands toward zero power, where f32 log()
    is ill-conditioned, so the energy-relative RMS is held tight and the
    tail bounded."""
    g = _golden()
    wav = torch.tensor(g[f"{name}_wav"], dtype=torch.float32)[None]
    got = kaldi_mfcc(wav, IV_PLDA_MFCC)[0].numpy()
    want = g[f"{name}_mfcc24"]
    err = got - want
    rel_rms = np.sqrt((err ** 2).mean()) / np.sqrt((want ** 2).mean())
    assert rel_rms < 2e-2
    assert np.abs(err).max() < 1.5


@pytest.mark.parametrize("name", ["noise", "sweep", "voiced"])
def test_delta_cmvn_match_golden(name):
    g = _golden()
    d = add_delta(torch.tensor(g[f"{name}_mfcc24"].astype(np.float32))[None])
    np.testing.assert_allclose(d[0].numpy(), g[f"{name}_delta"], rtol=1e-4,
                               atol=1e-5)
    c = sliding_cmvn(torch.tensor(g[f"{name}_delta"].astype(np.float32))[None])
    np.testing.assert_allclose(c[0].numpy(), g[f"{name}_cmvn"], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("t", [40, 301, 700])
def test_cmvn_matches_jax_across_window_regimes(t):
    """t <= 300 is one global window; longer inputs slide."""
    feat = np.random.default_rng(t).standard_normal((2, t, 6)).astype(
        np.float32)
    want = np.asarray(jax_cmvn.sliding_cmvn(jnp.asarray(feat)))
    np.testing.assert_allclose(sliding_cmvn(torch.tensor(feat)).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    for a, b in zip(window_bounds(t), jax_cmvn.window_bounds(t)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("length", [8000, 6401, 48000])
def test_framing_fold_vjp_matches_gather_autograd_and_jax(length):
    """frame_signal's hand VJP (JAX kaldi_mfcc.py _framer) against autograd
    of the plain gather (f32 round-off: the same sums of up to 3 overlapping
    taps plus an edge reflection, in another order) and against the JAX
    package's fold (the same adds in the same order: equal)."""
    from speakerguard_tpu_torch.ops.kaldi_mfcc import _frame_index, frame_signal
    wavs = _wavs(5, length=length)
    x = torch.tensor(wavs, requires_grad=True)
    frames = frame_signal(x, IV_PLDA_MFCC)
    cot = torch.tensor(np.random.default_rng(6).standard_normal(
        tuple(frames.shape)).astype(np.float32))
    (frames * cot).sum().backward()
    x_plain = torch.tensor(wavs, requires_grad=True)
    plain = x_plain[:, _frame_index(length, IV_PLDA_MFCC, x_plain.device)]
    assert torch.equal(frames, plain)
    (plain * cot).sum().backward()
    want = np.asarray(jax.grad(lambda w: jnp.sum(
        jax_mfcc.frame_signal(w, jax_mfcc.IV_PLDA_MFCC)
        * jnp.asarray(cot.numpy())))(jnp.asarray(wavs)))
    scale = float(x_plain.grad.abs().max())
    np.testing.assert_allclose(x.grad.numpy(), x_plain.grad.numpy(),
                               rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("length", [8000, 6401])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_mfcc_mirror_matches_jax(name, length):
    """The fused kernel's plain mirror (ops/mfcc_fast.py) with float32 DFT
    operands against the JAX frontend, value and input gradient, in the
    x-vector, i-vector and ECAPA configurations, no dither: the same
    mathematics with the sums in another order (its dropped Nyquist bin has
    zero mel weight), within 1e-5 of the largest entry."""
    cfg = CONFIGS[name]
    jcfg = jax_mfcc.MfccConfig(num_mel_bins=cfg.num_mel_bins,
                               num_ceps=cfg.num_ceps)
    wav, _, cot = _case(2, length, cfg, False, seed=7)
    w, c = wav.numpy(), cot.numpy()
    want = np.asarray(jax_mfcc.kaldi_mfcc(jnp.asarray(w), jcfg))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_mfcc.kaldi_mfcc(x, jcfg) * c))(jnp.asarray(w)))
    got, g = _value_and_grad(_mirror(cfg, None, torch.float32), wav, cot)
    assert _rel(got, torch.tensor(want)) <= 1e-5
    assert _rel(g, torch.tensor(want_g)) <= 1e-5
