"""mfcc_roofline_pct (``metrics/mfcc_roofline_pct.py``) and its counter
(``flops/mfcc.py``) against hand counts on synthetic traces."""

import math
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.flops import mfcc, peaks
from benchmark.trace import Event, Trace
from conftest import small_cell

FWD = ("void (anonymous namespace)::mfcc_fwd_kernel(CUtensorMap, "
       "(anonymous namespace)::MfccArgs)")
GM = ("(anonymous namespace)::mfcc_bwd_gm_kernel((anonymous "
      "namespace)::MfccArgs, int)")
BWD = ("void (anonymous namespace)::mfcc_bwd_kernel(CUtensorMap, "
       "CUtensorMap, (anonymous namespace)::MfccArgs)")


@pytest.mark.parametrize("dither", [1.0, 0.0])
def test_work_by_hand(dither):
    cfg = {"frontend": {"sample_rate": 16000, "frame_length_ms": 25,
                        "frame_shift_ms": 10, "num_mel_bins": 30,
                        "num_ceps": 24, "dither": dither}}
    # 3 waves of 8,000 samples: 50 frames of 400, an FFT of 512
    ops = 3 * 50 * (2.5 * 512 * math.log2(512) + 2 * 257 * 30 + 2 * 30 * 24)
    wave, noise, feats = 4 * 3 * 8000, 4 * 3 * 50 * 400 * dither, \
        4 * 3 * 50 * 24
    assert mfcc.fwd(cfg, 3, 8000) == (pytest.approx(ops),
                                      wave + noise + feats)
    assert mfcc.bwd(cfg, 3, 8000) == (pytest.approx(ops),
                                      feats + 2 * wave + noise)


def _ctx(n_fwd, n_gm, n_bwd, calls=2, cell=None):
    ev = ([Event(FWD, 1000 * i, 1000 * i + 400) for i in range(n_fwd)]
          + [Event(GM, 10**6 + 1000 * i, 10**6 + 1000 * i + 100)
             for i in range(n_gm)]
          + [Event(BWD, 2 * 10**6 + 1000 * i, 2 * 10**6 + 1000 * i + 600)
             for i in range(n_bwd)])
    return SimpleNamespace(trace=Trace(window=(0, 10**7), kernels=ev),
                           calls=calls,
                           cell=cell or small_cell("xv_plda", "pgd10_b512"))


def test_mfcc_roofline_by_hand():
    cell = small_cell("xv_plda", "pgd10_b512")      # 4 waves, 8,000 samples
    reader = harness.part("metrics", "mfcc_roofline_pct")
    launches = 10 * 2                                # max_iter x calls
    per = (peaks.bound_s(*mfcc.fwd(cell.config, 4, 8000))
           + peaks.bound_s(*mfcc.bwd(cell.config, 4, 8000)))
    got = reader.read(_ctx(launches, launches, launches, cell=cell))
    want = 100 * launches * per / (launches * (400 + 100 + 600) * 1e-9)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("n_fwd, n_gm, n_bwd", [
    (20, 20, 19), (20, 19, 20), (21, 20, 20), (0, 20, 20), (20, 0, 0),
    (0, 0, 0), (30, 20, 20)])
def test_mfcc_roofline_reads_nothing_without_every_launch(n_fwd, n_gm,
                                                          n_bwd):
    """A kernel short of (or past) one launch an iteration of each call
    leaves the metric out; so does a trace without the kernels (the
    parent's), and an iv cell's extra forward of the top-K context."""
    reader = harness.part("metrics", "mfcc_roofline_pct")
    assert reader.read(_ctx(n_fwd, n_gm, n_bwd)) is None
