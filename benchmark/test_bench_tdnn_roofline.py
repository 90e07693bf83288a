"""tdnn_roofline_pct (``metrics/tdnn_roofline_pct.py``) and its counter
(``flops/tdnn.py``) against hand counts on synthetic traces."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.flops import peaks, tdnn
from benchmark.trace import Event, Trace
from conftest import small_cell

FWD = ("void (anonymous namespace)::tdnn_conv_fwd_kernel(CUtensorMap, "
       "CUtensorMap, (anonymous namespace)::ConvArgs)")
BWD = ("void (anonymous namespace)::tdnn_conv_bwd_kernel<64>(CUtensorMap, "
       "CUtensorMap, (anonymous namespace)::ConvArgs)")


def test_layer_counts_by_hand():
    cfg = {"frontend": {"num_ceps": 3}, "tdnn": [[2, 1, 4], [1, 1, 5]]}
    # layer 1: T 10 -> 9, 2 x 2 x 9 x 3 x 2 x 4 operations; x, w, y
    # layer 2: T 9 -> 9, 2 x 2 x 9 x 4 x 1 x 5
    assert tdnn.layers(cfg, 2, 10) == [
        (864.0, 2.0 * (60 + 24 + 72)), (720.0, 2.0 * (72 + 20 + 90))]


def _ctx(n_fwd, n_bwd, calls=2, cell=None):
    ev = ([Event(FWD, 1000 * i, 1000 * i + 400) for i in range(n_fwd)]
          + [Event(BWD, 10**6 + 1000 * i, 10**6 + 1000 * i + 600)
             for i in range(n_bwd)])
    return SimpleNamespace(trace=Trace(window=(0, 10**7), kernels=ev),
                           calls=calls,
                           cell=cell or small_cell("xv_plda", "pgd10_b512"))


def test_tdnn_roofline_by_hand():
    cell = small_cell("xv_plda", "pgd10_b512")      # 4 waves, 50 frames
    reader = harness.part("metrics", "tdnn_roofline_pct")
    # the small configuration: 30 ceps, then 32 channels (64 on layer 5)
    t, cin, per_iter = 50, 30, 0.0
    for (k, d, c) in cell.config["tdnn"]:
        t_out = t - (k - 1) * d
        per_iter += peaks.bound_s(2.0 * 4 * t_out * cin * k * c,
                                  2.0 * (4 * t * cin + c * cin * k
                                         + 4 * t_out * c))
        t, cin = t_out, c
    launches = 5 * 10 * 2                 # layers x max_iter x calls
    got = reader.read(_ctx(launches, launches, cell=cell))
    want = 100 * 2 * (2 * 10 * per_iter) / (launches * (400 + 600) * 1e-9)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("n_fwd, n_bwd", [(100, 99), (99, 100), (0, 100),
                                          (100, 0), (0, 0), (110, 110)])
def test_tdnn_roofline_reads_nothing_without_every_launch(n_fwd, n_bwd):
    """A direction short of (or past) one launch a layer an iteration of
    each call leaves the metric out; so does a trace without the kernel
    (the parent's)."""
    reader = harness.part("metrics", "tdnn_roofline_pct")
    assert reader.read(_ctx(n_fwd, n_bwd)) is None
