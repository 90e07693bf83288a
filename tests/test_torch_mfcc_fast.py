"""ops/mfcc_fast.py: the fast path's fused Kaldi MFCC.  On the CPU its
plain mirror and the kernel wrappers' plumbing; on the card (``-m cuda``)
the kernels themselves.

The mirror with float32 DFT operands is pinned to today's chain
(``mfcc_chain(fast_dft=True)``, float32 on the CPU), value and input
gradient, in the x-vector, i-vector and ECAPA configurations (and to the
JAX package's frontend in tests/test_torch_frontend.py): the same
mathematics, only the sums in another order (the Nyquist bin it drops has
zero mel weight, the sine of bin 0 is zero), so within 1e-5 of the
largest entry.  With bf16 operands it is pinned to today's chain with
its DFT products in bf16 (``_Power`` at the card's dtype, the products
exact on bf16 operands): the same values rounded at the same points,
except that a value the two sum orders leave on either side of a bf16
rounding boundary moves one product term by one bf16 ulp, so within 1e-4
of the largest entry (bf16 against float32 operands differ by 1e-3 to
1e-1 of it).

On the card the kernels are held first to the mirror with bf16 operands:
the same values rounded at the same points, the sums in another order.
At the card's sizes that order moves the spectra of a few frames' weakest
bins, whose log the lowest mel filters take, so the bars (``MIRROR_BARS``)
are set from readings: the largest gap over the largest entry, and the
gap's norm over the mirror's.  Second, they are held to the float32 exact
chain by the fast path's own bar: their largest error is at most 1.5
times that of today's fast chain on the same inputs, plus 1e-5 of the
largest entry.

This file imports no JAX, so the card runs it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from speakerguard_tpu_torch.ops import kaldi_mfcc as KM
from speakerguard_tpu_torch.ops import mfcc_fast as MF
from speakerguard_tpu_torch.models.ecapa import ECAPA_MFCC

CONFIGS = {"xv": KM.XV_PLDA_MFCC, "iv": KM.IV_PLDA_MFCC, "ecapa": ECAPA_MFCC}


def _case(b, length, cfg, dither, device="cpu", seed=0):
    """Waves uniform in +-0.3 of int16's range, the dither's draw (or
    None) and a cotangent of the features."""
    gen = torch.Generator(device=device).manual_seed(seed)
    wav = (torch.rand(b, length, generator=gen, device=device) * 2 - 1) \
        * (0.3 * 32768)
    t = KM.num_frames(length, cfg)
    noise = (torch.randn(b, t, cfg.window_size, generator=gen, device=device)
             if dither else None)
    cot = torch.randn(b, t, cfg.num_ceps, generator=gen, device=device)
    return wav, noise, cot


def _value_and_grad(fn, wav, cot):
    x = wav.clone().requires_grad_(True)
    feat = fn(x)
    (g,) = torch.autograd.grad((feat * cot).sum(), x)
    return feat.detach(), g


def _mirror(cfg, noise, dtype):
    def fn(x):
        return _MirrorFn.apply(x, noise, cfg, dtype)
    return fn


class _MirrorFn(torch.autograd.Function):
    """The plain mirror at ``dtype`` under autograd."""

    @staticmethod
    def forward(ctx, wav, noise, cfg, dtype):
        feat, mel = MF.mfcc_fwd_plain(wav, noise, cfg, dtype)
        ctx.save_for_backward(wav, mel)
        ctx.noise, ctx.cfg, ctx.dtype = noise, cfg, dtype
        return feat

    @staticmethod
    def backward(ctx, cot):
        wav, mel = ctx.saved_tensors
        return (MF.mfcc_bwd_plain(wav, ctx.noise, ctx.cfg, mel, cot,
                                  ctx.dtype), None, None, None)


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _rel_norm(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


# The kernels against the bf16 mirror on the card: (largest gap over the
# largest entry, the gap's norm over the mirror's) of the features and of
# the input gradient.  Sound, over the card cases below and three seeds of
# each cell's shape, they read at most 5.9e-4 and 6.8e-6 (features), 8.1e-4
# and 1.6e-4 (gradient).  Planted faults at the cells' shapes read: a
# tile's halo left out of one utterance's gradient 0.024 and 2.0e-3 or
# more; a frame's DC term left out 0.017 and 9.2e-3; the mirrored start
# left out 0.076 and 0.013; one bin's weights given to the next filters
# 0.055 and 0.017 (features); one mel weight 10% off 1.6e-3 and 1.4e-3
# (features), 1.7e-3 in the gradient's norm; 1% off 1.4e-4 in the
# features' norm.  The norm bars sit 3-4x above the sound readings and
# 3-5x below the weight faults; the largest-gap bars 5x above the sound
# and 4x below the halo, DC and edge faults.
MIRROR_BARS = {"features": (4e-3, 3e-5), "gradient": (4e-3, 5e-4)}


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_nyquist_mel_column_and_sine_of_bin_zero_are_zero(name):
    """The two facts that let the kernel drop bin 256 and keep one zero
    row: and each bin feeds at most two neighbouring filters."""
    cfg = CONFIGS[name]
    assert not KM.mel_banks(cfg)[:, 256].any()
    _, sin = KM.dft_matrices(KM.feature_window(cfg), cfg.padded_window_size,
                             cfg.preemphasis_coefficient)
    assert not sin[0].any()
    dft = MF.dft_chunked(cfg)
    assert dft.shape == (512, 400) and not dft[64].any()   # -sin of bin 0
    t = MF.mel_tables(cfg)
    banks = KM.mel_banks(cfg)[:, :256]
    rebuilt = np.zeros_like(banks)
    for k in range(256):
        rebuilt[t["bin_lo"][k], k] += t["bin_w"][k, 0]
        if t["bin_lo"][k] + 1 < cfg.num_mel_bins:
            rebuilt[t["bin_lo"][k] + 1, k] += t["bin_w"][k, 1]
        else:
            assert t["bin_w"][k, 1] == 0
    np.testing.assert_array_equal(rebuilt, banks)


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("length", [8000, 6401, 520])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mirror_matches_todays_chain(name, length, dither):
    """float32 operands: the mirror against ``mfcc_chain(fast_dft=True)``
    on the CPU, value and input gradient; 520 samples is 3 frames, both
    mirrored edges inside one frame's reach."""
    cfg = CONFIGS[name]
    wav, noise, cot = _case(2, length, cfg, dither, seed=length)
    want = _value_and_grad(lambda x: KM.mfcc_chain(x, cfg, noise, True),
                           wav, cot)
    got = _value_and_grad(_mirror(cfg, noise, torch.float32), wav, cot)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mirror_bf16_matches_todays_bf16_products(name, monkeypatch):
    """bf16 operands: today's chain with its DFT products in bf16 (the
    card's dtype; the products of bf16 operands summed in float32 on the
    CPU) against the mirror: the same values rounded at the same points."""
    cfg = CONFIGS[name]
    wav, noise, cot = _case(2, 6401, cfg, True, seed=5)
    monkeypatch.setattr(KM, "fast_dot_dtype", lambda dev: torch.bfloat16)
    monkeypatch.setattr(KM, "dot_f32", lambda a, b: a.float() @ b.float())
    want = _value_and_grad(lambda x: KM.mfcc_chain(x, cfg, noise, True),
                           wav, cot)
    got = _value_and_grad(_mirror(cfg, noise, torch.bfloat16), wav, cot)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


@pytest.fixture
def emulated(monkeypatch):
    """Both wrappers' kernel route on CPU tensors: each launch writes the
    mirror's results into the buffers it is handed, read in the entry
    point's argument order."""
    def fwd(entry, device, wav, noise, dither, b, length, t, nmel, nceps,
            dft, mel_lo, mel_hi, bin_lo, bin_w, dct_t, dct_ld, lifter, feat,
            mel):
        assert entry == "sg_mfcc_fwd" and wav.is_contiguous()
        assert (b, length) == tuple(wav.shape)
        cfg = _cfg_of(nmel, nceps, dither)
        got = MF.mfcc_fwd_plain(wav, noise, cfg, torch.bfloat16)
        assert dft.dtype == torch.bfloat16 and tuple(dft.shape) == (512, 400)
        assert mel_lo.dtype == mel_hi.dtype == bin_lo.dtype == torch.int32
        assert dct_ld % 8 == 0 and tuple(dct_t.shape) == (nmel, dct_ld)
        assert torch.equal(dct_t[:, :nceps], MF._consts(cfg, wav.device)[
            "dct"].T) and not dct_t[:, nceps:].any()
        feat.copy_(got[0])
        mel.copy_(got[1])

    def bwd(entry, device, wav, noise, dither, b, length, t, nmel, nceps,
            dft, dft_t, bin_lo, bin_w, dct, dct_ld, lifter, mel, cot, gm,
            gld, gwav):
        assert entry == "sg_mfcc_bwd" and cot.is_contiguous()
        assert gld % 4 == 0 and nmel < gld <= nmel + 4
        assert tuple(gm.shape) == (b, t, gld)
        assert tuple(dft_t.shape) == (400, 512) and bin_lo.dtype == torch.int32
        assert dct_ld % 8 == 0 and dct_ld > nmel
        assert tuple(dct.shape) == (nceps, dct_ld) and not dct[:, nmel:].any()
        cfg = _cfg_of(nmel, nceps, dither)
        gwav.copy_(MF.mfcc_bwd_plain(wav, noise, cfg, mel, cot,
                                     torch.bfloat16))

    for w, launch in ((MF.mfcc_fwd, fwd), (MF.mfcc_bwd, bwd)):
        monkeypatch.setattr(w, "on_card", lambda t, what: True)
        monkeypatch.setattr(w, "lib", SimpleNamespace(launch=launch))
        w.reset_counts()
    yield
    for w in (MF.mfcc_fwd, MF.mfcc_bwd):
        w.reset_counts()


def _cfg_of(nmel, nceps, dither):
    return next(c for c in CONFIGS.values()
                if (c.num_mel_bins, c.num_ceps, c.dither) ==
                (nmel, nceps, dither))


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_route_plumbing(emulated, monkeypatch, name, dither):
    """The autograd node through both wrappers' kernel route: one launch a
    direction, the buffers in the entry points' order, and the plain
    route's numbers exactly."""
    cfg = CONFIGS[name]
    wav, noise, cot = _case(3, 4001, cfg, dither, seed=11)
    got = _value_and_grad(lambda x: MF.mfcc(x, cfg, noise), wav,
                          cot.transpose(0, 1).contiguous().transpose(0, 1))
    assert (MF.mfcc_fwd.launches, MF.mfcc_bwd.launches) == (1, 1)
    for w in (MF.mfcc_fwd, MF.mfcc_bwd):
        monkeypatch.setattr(w, "route", lambda t: False)
    want = _value_and_grad(_mirror(cfg, noise, torch.bfloat16), wav, cot)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_tensors_take_the_plain_version_and_cpu_kaldi_mfcc_none():
    """On the CPU the wrappers run the mirror (counted as plain calls) at
    the CPU fast path's float32, so within 1e-5 of today's chain;
    ``kaldi_mfcc(fast_dft=True)`` on the CPU is today's chain and touches
    neither wrapper."""
    cfg = CONFIGS["xv"]
    wav, noise, cot = _case(2, 3000, cfg, True, seed=2)
    for w in (MF.mfcc_fwd, MF.mfcc_bwd):
        w.reset_counts()
    got = _value_and_grad(lambda x: MF.mfcc(x, cfg, noise), wav, cot)
    counts = [(w.launches, w.plain_calls) for w in (MF.mfcc_fwd, MF.mfcc_bwd)]
    assert counts == [(0, 1), (0, 1)]
    want = _value_and_grad(lambda x: KM.mfcc_chain(x, cfg, noise, True),
                           wav, cot)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    for w in (MF.mfcc_fwd, MF.mfcc_bwd):
        w.reset_counts()
    gen = torch.Generator().manual_seed(3)
    _value_and_grad(lambda x: KM.kaldi_mfcc(x, cfg, rng=gen, fast_dft=True),
                    wav, cot)
    counts = [(w.launches, w.plain_calls) for w in (MF.mfcc_fwd, MF.mfcc_bwd)]
    assert counts == [(0, 0), (0, 0)]


BAD = {"snip_edges": dict(snip_edges=True),
       "energy_off": dict(use_energy=False),
       "energy_floor": dict(energy_floor=1.0),
       "window": dict(frame_length_ms=20.0),
       "no_dc": dict(remove_dc_offset=False),
       "ceps_over_mel": dict(num_mel_bins=20, num_ceps=24)}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses_configurations_it_does_not_cover(emulated, case):
    cfg = KM.MfccConfig(**BAD[case])
    wav = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="does not cover"):
        MF.mfcc(wav, cfg)
    assert MF.mfcc_fwd.launches == 0


def test_wrapper_refuses_a_wave_too_short_and_bad_noise(emulated):
    cfg = CONFIGS["xv"]
    with pytest.raises(ValueError):
        MF.mfcc(torch.zeros(1, 100), cfg)
    with pytest.raises(ValueError, match="noise"):
        MF.mfcc(torch.zeros(2, 4000), cfg, torch.zeros(2, 24, 400))
    assert MF.mfcc_fwd.launches == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (batch, samples): 300 frames (5 tiles of 64, the last 44), 125 frames, 25
# frames (one tile, under 64), 1 frame (both mirrored edges in one frame);
# lengths not a multiple of 4 start each wave row at another alignment
CARD_CASES = {"b512_l48000": (512, 48000), "b3_l20000": (3, 20000),
              "b1_l4000": (1, 4000), "b2_l200": (2, 200),
              "b2_l20001": (2, 20001), "b3_l4003": (3, 4003)}


def _card_errors(cfg, b, length, dither, seed):
    wav, noise, cot = _case(b, length, cfg, dither, device="cuda", seed=seed)
    mirror = _value_and_grad(_mirror(cfg, noise, torch.bfloat16), wav, cot)
    exact = _value_and_grad(lambda x: KM.mfcc_chain(x, cfg, noise, False),
                            wav, cot)
    old = _value_and_grad(lambda x: KM.mfcc_chain(x, cfg, noise, True),
                          wav, cot)
    for w in (MF.mfcc_fwd, MF.mfcc_bwd):
        w.reset_counts()
    gen = _Replay(noise)
    new = _value_and_grad(lambda x: KM.kaldi_mfcc(
        x, cfg, rng=gen if dither else None, fast_dft=True), wav, cot)
    again = _value_and_grad(lambda x: MF.mfcc(x, cfg, noise), wav, cot)
    torch.cuda.synchronize()
    return mirror, exact, old, new, again


class _Replay:
    """A dither draw function that returns the given noise."""

    def __init__(self, noise):
        self.noise = noise

    def __call__(self, shape):
        assert tuple(shape) == tuple(self.noise.shape)
        return self.noise


@pytest.mark.cuda
@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernels_match_the_chain_on_card(name, case, dither):
    """Features and input gradient through ``kaldi_mfcc(fast_dft=True)``
    on the card: one launch a direction, within ``MIRROR_BARS`` of the
    bf16 mirror, within the fast path's own bar of the float32 chain, and
    the same bits on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = CONFIGS[name]
    b, length = CARD_CASES[case]
    mirror, exact, old, new, again = _card_errors(cfg, b, length, dither,
                                                  seed=b)
    assert (MF.mfcc_fwd.launches, MF.mfcc_bwd.launches) == (2, 2)
    assert (MF.mfcc_fwd.plain_calls, MF.mfcc_bwd.plain_calls) == (0, 0)
    for what, got, want in zip(("features", "gradient"), new, mirror):
        gap = (_rel(got, want), _rel_norm(got, want))
        assert all(g <= bar for g, bar in zip(gap, MIRROR_BARS[what])), \
            (what, gap)
    for got, prev, want in zip(new, old, exact):
        top = float(want.abs().max())
        err_new = float((got - want).abs().max())
        err_old = float((prev - want).abs().max())
        assert err_new <= 1.5 * err_old + 1e-5 * top, (err_new, err_old, top)
    for got, rerun in zip(new, again):
        assert torch.equal(got, rerun)


@pytest.mark.cuda
def test_kaldi_mfcc_refuses_an_uncovered_configuration_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wav = torch.zeros(2, 4000, device="cuda")
    with pytest.raises(ValueError, match="does not cover"):
        KM.kaldi_mfcc(wav, KM.MfccConfig(snip_edges=True), fast_dft=True)
