"""The ECAPA-TDNN configuration's files: its counter (``flops/
ecapa_tdnn.py``) and roofline readers (``metrics/ecapa_conv_roofline_pct
.py``, ``metrics/asp_stats_roofline_pct.py``) against hand counts, its
reference (``reference/ecapa_tdnn.py``)
against tests/ecapa_reference.py and against the port's exact path, and a
small run's ``correct`` with and without the planted faults, on the CPU at
small widths (C = 64, scale 8, SE and attention 16, MFA 96, embedding
24)."""

import copy
import json
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import faults, harness
from benchmark.flops import ecapa_tdnn, frontend, peaks
from benchmark.trace import Event, Trace
from conftest import BENCH, ROOT

FWD = ("void (anonymous namespace)::tdnn_conv_fwd_kernel<128, true>("
       "CUtensorMap, CUtensorMap, (anonymous namespace)::ConvArgs)")
BWD = ("void (anonymous namespace)::tdnn_conv_bwd_kernel<256>(CUtensorMap, "
       "CUtensorMap, (anonymous namespace)::ConvArgs)")


def _config():
    return json.loads((BENCH / "configs" / "ecapa_tdnn.json").read_text())


def small_config():
    cfg = _config()
    cfg.update(channels=64, se_channels=16, attention_channels=16,
               mfa_channels=96, embedding_dim=24)
    return cfg


def small_cell(**over):
    mix = json.loads((BENCH / "traffic" / "pgd10_b256_ecapa.json")
                     .read_text())
    mix.update(batch=4, samples=8000, warmup_calls=1, trace_calls=1,
               reference_block=2, shortfall_calls=2, shortfall_rows=4,
               judge_calls=2)
    mix.update(over)
    return harness.Cell(name="small_ecapa", config=small_config(),
                        traffic=copy.deepcopy(mix))


def test_parameters_at_the_published_widths():
    """C = 1024, MFA 1536: 14,660,416 trainable weights, the paper's
    14.7 M."""
    assert ecapa_tdnn.parameters(_config()) == 14_660_416


def test_blocks_by_hand():
    cfg = {"frontend": {"num_ceps": 3}, "channels": 8, "res2net_scale": 4,
           "kernel_sizes": [5, 3, 3, 3, 1], "dilations": [1, 2, 3, 4, 1],
           "mfa_channels": 12, "attention_channels": 4}
    got = ecapa_tdnn.blocks(cfg, 2, 10)
    # h0, 3 x (tdnn1, 3 branches, tdnn2), MFA, the pooling's first layer
    assert len(got) == 1 + 3 * 5 + 2
    rows = 2 * 10
    assert got[0] == (2.0 * rows * 3 * 5 * 8,
                      2.0 * (rows * 3 + 8 * 3 * 5 + rows * 8))
    assert got[1] == (2.0 * rows * 8 * 8, 2.0 * (rows * 8 + 64 + rows * 8))
    assert got[2] == (2.0 * rows * 2 * 3 * 2,
                      2.0 * (rows * 2 + 2 * 2 * 3 + rows * 2))
    assert got[-2] == (2.0 * rows * 24 * 12,
                       2.0 * (rows * 24 + 12 * 24 + rows * 12))
    assert got[-1] == (2.0 * rows * 36 * 4,
                       2.0 * (rows * 36 + 4 * 36 + rows * 4))
    assert len(ecapa_tdnn.blocks(_config(), 1, 1)) == 30


def test_forward_by_hand():
    cfg = small_config()
    t = 50
    convs = sum(2 * t * cin * k * cout for cin, cout, k in (
        [(80, 64, 5)] + 3 * ([(64, 64, 1)] + [(8, 8, 3)] * 7 + [(64, 64, 1)])
        + [(192, 96, 1), (288, 16, 1)]))
    se = 3 * 2 * (64 * 16 + 16 * 64)
    rest = 2 * t * 16 * 96 + 2 * (192 * 24 + 10 * 24)
    want = frontend.forward(cfg, 1, 8000) + convs + se + rest
    assert ecapa_tdnn.forward(cfg, 1, 8000) == pytest.approx(want)
    mix = small_cell().traffic
    assert ecapa_tdnn.attack(cfg, mix) == pytest.approx(
        21 * ecapa_tdnn.forward(cfg, 4, 8000))


def _ctx(n_fwd, n_bwd, calls=2):
    ev = ([Event(FWD, 1000 * i, 1000 * i + 400) for i in range(n_fwd)]
          + [Event(BWD, 10**6 + 1000 * i, 10**6 + 1000 * i + 600)
             for i in range(n_bwd)])
    return SimpleNamespace(trace=Trace(window=(0, 10**7), kernels=ev),
                           calls=calls, cell=small_cell())


def test_roofline_by_hand():
    reader = harness.part("metrics", "ecapa_conv_roofline_pct")
    work = ecapa_tdnn.blocks(small_config(), 4, 50)
    per_iter = sum(peaks.bound_s(o, b) for o, b in work)
    launches = 30 * 10 * 2              # blocks x max_iter x calls
    got = reader.read(_ctx(launches, launches))
    want = 100 * 2 * (2 * 10 * per_iter) / (launches * (400 + 600) * 1e-9)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("n_fwd, n_bwd", [(600, 599), (599, 600), (0, 600),
                                          (600, 0), (0, 0), (610, 610)])
def test_roofline_reads_nothing_without_every_launch(n_fwd, n_bwd):
    """A direction short of (or past) one launch a block an iteration of
    each call leaves the metric out; so does a trace without the kernel
    (the parent's, which has no such cell)."""
    reader = harness.part("metrics", "ecapa_conv_roofline_pct")
    assert reader.read(_ctx(n_fwd, n_bwd)) is None


POOL_FWD = ("void (anonymous namespace)::asp_stats_fwd_kernel(float const*, "
            "__nv_bfloat16 const*, int, int, int, float, float*, float*, "
            "float*, float*, float*)")
POOL_BWD = "void (anonymous namespace)::asp_stats_bwd_kernel(float const*)"


def test_pool_counts_by_hand():
    cfg = {"mfa_channels": 3}
    n = 2 * 5 * 3                        # B T C
    assert ecapa_tdnn.pool_fwd(cfg, 2, 5) == (9.0 * n,
                                               4.0 * n + 2 * n + 20 * 6)
    assert ecapa_tdnn.pool_bwd(cfg, 2, 5) == (12.0 * n,
                                               12.0 * n + 28 * 6)


def _pool_ctx(n_fwd, n_bwd, calls=2):
    ev = ([Event(POOL_FWD, 1000 * i, 1000 * i + 300) for i in range(n_fwd)]
          + [Event(POOL_BWD, 10**6 + 1000 * i, 10**6 + 1000 * i + 500)
             for i in range(n_bwd)])
    return SimpleNamespace(trace=Trace(window=(0, 10**7), kernels=ev),
                           calls=calls, cell=small_cell())


def test_pool_roofline_by_hand():
    reader = harness.part("metrics", "asp_stats_roofline_pct")
    cfg = small_config()
    launches = 10 * 2                    # max_iter x calls
    want = 100 * launches * (
        peaks.bound_s(*ecapa_tdnn.pool_fwd(cfg, 4, 50))
        + peaks.bound_s(*ecapa_tdnn.pool_bwd(cfg, 4, 50))) / (
        launches * (300 + 500) * 1e-9)
    assert reader.read(_pool_ctx(launches, launches)) == pytest.approx(want)


@pytest.mark.parametrize("n_fwd, n_bwd", [(20, 19), (19, 20), (0, 20),
                                          (20, 0), (0, 0), (21, 21)])
def test_pool_roofline_reads_nothing_without_every_launch(n_fwd, n_bwd):
    reader = harness.part("metrics", "asp_stats_roofline_pct")
    assert reader.read(_pool_ctx(n_fwd, n_bwd)) is None


def _weights(seed, device):
    return harness.part("models", "ecapa_tdnn").make_weights(
        small_config(), seed, device)


def test_reference_matches_the_tests_reference(cpu):
    """benchmark/reference/ecapa_tdnn.py and tests/ecapa_reference.py, two
    writings of the same equations, on the same weights and features."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import ecapa_reference
    finally:
        sys.path.remove(str(ROOT / "tests"))
    cfg = small_config()
    w = _weights(7, cpu)
    ref = harness.part("reference", "ecapa_tdnn").Reference(w, cfg, cpu)
    feats = torch.randn(3, 60, 80, generator=torch.Generator().manual_seed(2))
    got = ref.embedding_from_feats(feats)
    want = ecapa_reference.embedding(w, feats)
    assert torch.allclose(got, want, rtol=0, atol=1e-6 * float(
        want.abs().max()))


def test_reference_scores_and_gradient_match_the_port(cpu):
    """The reference against the port's exact path on the same raw
    weights, waves and dither: scores within 1e-5 of the largest; and the
    waveform gradient PGD steps along, as test_bench_reference.py takes
    the x-vector's (no dither; rtol 1e-3, and 1e-4 of the largest entry).
    The networks' feature gradients agree to 1e-6; the rest is the front
    end, whose lowest of 80 mel filters span about one DFT bin, so that
    the port's DFT product and the reference's rfft, equal to float32
    rounding, give gradients up to 2e-4 of the largest apart at a frame
    there (4e-4 with the dither on)."""
    cfg = small_config()
    models = harness.part("models", "ecapa_tdnn")
    ref = harness.part("reference", "ecapa_tdnn").Reference(
        _weights(5, cpu), cfg, cpu)
    prog = models.build_program(_weights(5, cpu), cfg,
                                {"fast_path": {"enabled": False}}, cpu)
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(4, 8000, generator=g) * 2 - 1) * 0.3
    dither = torch.randn(4, 50, 400, generator=g)
    with torch.no_grad():
        got = prog.score(x, rng=lambda shape: dither)
        want = ref.scores(x, dither)
        plain = ref.scores(x, None)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
    assert float((plain - want).abs().max()) > 5 * err
    grads = []
    for fn in (lambda v: prog.score(v), lambda v: ref.scores(v)):
        v = x.clone().requires_grad_(True)
        (gr,) = torch.autograd.grad(fn(v)[:, 0].sum(), v)
        grads.append(gr)
    assert torch.allclose(grads[0], grads[1], rtol=1e-3,
                          atol=1e-4 * float(grads[1].abs().max()))


def _run(cell, cpu):
    out = harness.part("drivers", "attack_campaign").run(
        cell, 2**31 + 91, None, False, time.perf_counter(), cpu, calls=2)
    return all(c["value"] <= c["limit"] for c in out["checks"].values()), out


def _cell():
    cell = small_cell()
    # the CPU has no bf16 GEMM; the fast path still runs its own code
    cell.traffic["program"]["fast_path"]["enabled"] = True
    return cell


def test_sound_run_is_correct(cpu):
    ok, out = _run(_cell(), cpu)
    assert ok, out["checks"]
    assert out["attempted"] == 8 and out["failed"] == 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(fault, cpu):
    with faults.planted(fault):
        ok, out = _run(_cell(), cpu)
    assert not ok, out["checks"]
