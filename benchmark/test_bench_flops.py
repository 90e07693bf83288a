"""The operation and byte counters and the readers against hand counts."""

import math
from types import SimpleNamespace

import pytest

from benchmark import harness, readers
from benchmark.flops import chol, frontend, gmm, iv_plda, peaks, xv_plda
from benchmark.trace import Event, Trace
from conftest import small_cell, small_config


def test_frames_of_a_three_second_wave():
    assert frontend.frames(small_config("xv_plda"), 48000) == (300, 400, 512)


def test_frontend_count():
    cfg = small_config("xv_plda")
    # 2 waves x 50 frames: a real FFT of 512, 257 x 30 mel, 30 x 30 DCT
    per_frame = 2.5 * 512 * 9 + 2 * 257 * 30 + 2 * 30 * 30
    assert frontend.forward(cfg, 2, 8000) == pytest.approx(100 * per_frame)


def test_xv_forward_by_hand():
    cfg = small_config("xv_plda")
    f = frontend.forward(cfg, 1, 8000)
    t, convs = 50, 0.0
    for (k, d, c), cin in zip(cfg["tdnn"], [30, 32, 32, 32, 32]):
        t -= (k - 1) * d
        convs += 2 * t * cin * k * c
    head = 2 * (2 * 64 * 32 + 32 * 16 + 16 * 16 + 3 * 10 * 16)
    assert xv_plda.forward(cfg, 1, 8000) == pytest.approx(f + convs + head)


def test_xv_attack_is_21_forwards():
    cell = small_cell("xv_plda", "pgd10_b512")
    f = xv_plda.forward(cell.config, 4, 8000)
    assert xv_plda.attack(cell.config, cell.traffic) == pytest.approx(21 * f)


def test_iv_forward_by_hand():
    cfg = small_config("iv_plda")   # D 72, F 2700, C 16, IV 32, R 16
    n = 50
    ops = (frontend.forward(cfg, 1, 8000) + 2 * n * 16 * (2700 + 72)
           + 2 * 16 * (528 + 72 * 32) + 2 * 32 ** 3 / 3 + 2 * 32 ** 2
           + 2 * (32 * 16 + 16 * 16 + 3 * 10 * 16))
    assert iv_plda.forward(cfg, 1, 8000, 16) == pytest.approx(ops)


def test_iv_attack_counts_the_top_k_choice():
    cell = small_cell("iv_plda", "pgd10_b256")
    cfg, b = cell.config, 4
    cell.traffic["program"]["fast_path"]["gmm_topk"] = 8
    it = (iv_plda.forward(cfg, b, 8000, 8)
          + iv_plda.input_gradient(cfg, b, 8000, 8))
    choice = frontend.forward(cfg, b, 8000) + 2 * b * 50 * 16 * 2700
    want = choice + 10 * it + iv_plda.forward(cfg, b, 8000, 16)
    assert iv_plda.attack(cfg, cell.traffic) == pytest.approx(want)
    # gmm_topk 0 (the kernels' path): every component, no choice
    cell.traffic["program"]["fast_path"]["gmm_topk"] = 0
    it = (iv_plda.forward(cfg, b, 8000, 16)
          + iv_plda.input_gradient(cfg, b, 8000, 16))
    assert iv_plda.attack(cfg, cell.traffic) == pytest.approx(
        10 * it + iv_plda.forward(cfg, b, 8000, 16))


def test_chol_sweep_by_hand():
    # 2 matrices of 3: 2 * 2 * 27 / 3 operations; 6 entries in, 6 out
    assert chol.sweep(2, 3, 4) == (36.0, 96.0)
    assert chol.sweep(2, 3, 2) == (36.0, 72.0)


def test_gmm_counts_by_hand():
    cfg = {"frontend": {"num_ceps": 1}, "ubm_components": 2}  # D 3, F 9
    assert gmm.stats_fwd(cfg, 1, 2) == (96.0, 108.0)
    # 2*2*2*9 + 4*2*2*3 + 4*2*6; x, posts, dz, df, proj in, dx out
    assert gmm.stats_bwd(cfg, 1, 2) == (168.0, 24 + 8 + 32 + 36 + 24)
    assert gmm.loglike(cfg, 1, 2) == (72.0, 24 + 72 + 8 + 16)


def test_bound_is_the_larger_of_compute_and_bytes():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_kernel_name():
    assert readers.kernel_name(
        "void (anonymous namespace)::sweep_kernel<__nv_bfloat16, true, "
        "false>(__nv_bfloat16 const*, float const*, float*, float*, int)"
    ) == "sweep_kernel"
    assert readers.kernel_name("ampere_bf16_s16816gemm_bf16_128x64") == \
        "ampere_bf16_s16816gemm_bf16_128x64"


def _ctx(kernels, window=(0, 1_000_000), calls=1, cell=None):
    return SimpleNamespace(
        trace=Trace(window=window, kernels=[Event(*k) for k in kernels]),
        calls=calls, cell=cell or small_cell("iv_plda", "pgd10_b256_gmmk"))


def test_idle_and_kernels_per_attack_readers():
    idle = harness.part("metrics", "device_idle_pct.attack")
    per = harness.part("metrics", "kernels_per_attack")
    ctx = _ctx([("a", 0, 300_000), ("b", 200_000, 500_000),
                ("c", 900_000, 1_000_000)], calls=2)
    assert idle.read(ctx) == pytest.approx(40.0)
    assert per.read(ctx) == pytest.approx(1.5)
    assert idle.read(_ctx([])) is None and per.read(_ctx([])) is None


def test_roofline_readers():
    cell = small_cell("iv_plda", "pgd10_b256_gmmk")
    b, n = 4, 32
    f32 = peaks.bound_s(*chol.sweep(b, n, 4))
    bf16 = peaks.bound_s(*chol.sweep(b, n, 2))
    ctx = _ctx([("void sweep_kernel<float, false, false>(float const*)",
                 0, 1000),
                ("void (anonymous namespace)::sweep_kernel<__nv_bfloat16, "
                 "true, false>(x)", 1000, 3000)], cell=cell)
    got = harness.part("metrics", "chol_roofline_pct").read(ctx)
    assert got == pytest.approx(100 * (f32 + bf16) / 3e-6)
    ll = harness.part("metrics", "loglike_roofline_pct")
    ctx = _ctx([("aug_split_kernel", 0, 1000),
                ("loglike_split_gemm_kernel", 1000, 5000)], cell=cell)
    want = 100 * peaks.bound_s(*gmm.loglike(cell.config, b, 50)) / 5e-6
    assert ll.read(ctx) == pytest.approx(want)
    st = harness.part("metrics", "gmm_stats_roofline_pct")
    ctx = _ctx([("aug16_kernel", 0, 1000),
                ("loglike_gemm_kernel", 1000, 3000),
                ("normalise_stats_kernel", 3000, 4000),
                ("dl_direct_kernel", 4000, 5000),
                ("daug_gemm_kernel", 5000, 7000),
                ("chain_sum_kernel", 7000, 8000)], cell=cell)
    want = 100 * (peaks.bound_s(*gmm.stats_fwd(cell.config, b, 50))
                  + peaks.bound_s(*gmm.stats_bwd(cell.config, b, 50))) / 8e-6
    assert st.read(ctx) == pytest.approx(want)
    # a kernel taken off the path leaves its roofline silent
    assert st.read(_ctx([("aug16_kernel", 0, 10)], cell=cell)) is None
    assert ll.read(_ctx([], cell=cell)) is None


def test_mfu_reader():
    cell = small_cell("xv_plda", "pgd10_b512")
    ctx = _ctx([("k", 0, 10)], window=(0, 2_000_000_000), calls=3,
               cell=cell)
    want = 100 * 3 * xv_plda.attack(cell.config, cell.traffic) / (
        2.0 * peaks.FLOPS)
    assert harness.part("metrics", "attack_mfu_pct").read(ctx) == \
        pytest.approx(want)
    assert not math.isnan(want)
