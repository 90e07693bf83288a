#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speakerguard_tpu_torch) on one card.

    python3 chip_smoke.py                 # what the checks need
    python3 chip_smoke.py --profile DIR   # also a torch.profiler table of
                                          # one PGD iteration, written to
                                          # DIR/profile_pgd1.txt

Phases, one JSON line each:
  1. device   the card's name and power limit (nvidia-smi); exits non-zero
              when torch sees no CUDA card.
  2. build    nvcc builds the port's one kernel source, csrc/chol.cu, into
              csrc/_build/.
  3. kernel   each kernel against its plain PyTorch version on the card at
              the main path's shapes and at odd shapes, on a diagonally
              dominant and an i-vector-shaped input: error, the blocked
              residual, strictly-lower zeros, CUDA-event times of the
              kernel, the plain version and one PyTorch library call, and
              the roofline bound.
  4. slice    the main path at full width: iv-PLDA (C=2048, D=72, IV=600,
              R=200, weights from a numpy seed), 10 enrolled speakers, task
              CSI-E, 64 utterances of 3 s; make_decision, then PGD (10
              iterations, eps 0.002, step 0.0004, Entropy).  The kernel
              launch counts are read around this run and must equal one
              factorization per PGD iteration plus one per exact evaluation.
              The card's scores are checked against the CPU plain path on a
              small model.
  5. kernels  one line listing every ported kernel.
Then the card's name and power limit, and last the line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, warmup, iters):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parse_ms(text):
    """'53.677ms' / '812.5us' / '1.2s' (torch.profiler's units) -> ms."""
    text = text.strip()
    for unit, scale in (("ms", 1.0), ("us", 1e-3), ("s", 1e3)):
        if text.endswith(unit):
            return float(text[:-len(unit)]) * scale
    raise ValueError(f"unknown time unit in {text!r}")


def chol_bound_ms(b, n, in_bytes, bf16_updates, nb):
    """Least time for the factorization on this card: the upper triangle of
    each input read once and the f32 factor written once, against N^3/3
    flops per matrix (the trailing-update share at the bf16 rate when its
    operands are bf16, the pivot steps at the f32 rate)."""
    byte_ms = (b * (n * (n + 1) / 2 * in_bytes + n * n * 4)
               / HBM_BYTES_PER_S * 1e3)
    total = n ** 3 / 3.0
    panel = 0.0   # flops of the sequential pivot steps inside the panels
    for k0 in range(0, n, nb):
        p = min(nb, n - k0)
        for j in range(p):
            panel += 2.0 * (p - j - 1) * (n - k0 - j - 1) + (n - k0 - j)
    trailing = max(total - panel, 0.0)
    if bf16_updates:
        op_ms = b * (panel / F32_FLOPS + trailing / BF16_FLOPS) * 1e3
    else:
        op_ms = b * total / F32_FLOPS * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms
                                 else "operations")


def spd_batch(torch, kind, b, n, seed, dtype):
    """'dominant': 0.01 X X^T + (N/10 + 0.5) I, off-diagonals of R ~ 0.03
    against a diagonal ~ 8.  'occupancy': shaped like the i-vector solve's
    L = I + sum_c N_c M_c^T M_c with few occupied components (2N / 72 of
    them, 72 feature dims each), so R's off-diagonals reach ~1 against a
    diagonal ~ 6 and a wrong trailing update shows at once."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    eye = torch.eye(n, device="cuda")
    if kind == "dominant":
        x = torch.randn((b, n, n), generator=g, device="cuda") * 0.1
        a = x @ x.mT + (n / 10.0 + 0.5) * eye
    else:
        comps = -(-2 * n // 72)
        m = torch.randn((comps * 72, n), generator=g, device="cuda") * 0.05
        occ = torch.rand((b, comps), generator=g, device="cuda") * 30.0
        a = eye + torch.einsum("kn,bk,km->bnm", m,
                               occ.repeat_interleave(72, dim=1), m)
    return a.to(dtype)


def phase_kernels(torch, chol):
    """Kernel vs plain on the card.  Returns the main-shape record.

    Every case holds the kernel's factor to ``chol.blocked_residual`` (A
    rebuilt from R with the sweep's own grouping and rounding) at 1e-5 of
    max |A|, and to the plain version at ``tol_plain`` of max |R|: 1e-5,
    except bf16_updates on the occupancy input at 2e-3.  There an f32
    summation-order difference of one ulp can move one of the 11.5M R
    entries across a bf16 rounding boundary, and the two factors then
    differ by ~2.4e-4; a skipped trailing update errs far above that
    there."""
    tol = 1e-5
    cases = [  # (name, input, B, N, dtype, bf16_updates, tol vs plain)
        ("main_f32", "dominant", 64, 600, torch.float32, False, tol),
        ("bf16_input", "dominant", 64, 600, torch.bfloat16, False, tol),
        ("bf16_updates", "dominant", 64, 600, torch.float32, True, tol),
        ("occupancy_f32", "occupancy", 64, 600, torch.float32, False, tol),
        ("occupancy_bf16_updates", "occupancy", 64, 600, torch.float32,
         True, 2e-3),
        ("odd_129", "dominant", 3, 129, torch.float32, False, tol),
        ("n_1", "dominant", 2, 1, torch.float32, False, tol),
    ]
    main = None
    for name, kind, b, n, dtype, upd, tol_plain in cases:
        a = spd_batch(torch, kind, b, n, seed=n, dtype=dtype)
        got = chol.cholesky_rt(a, bf16_updates=upd)
        torch.cuda.synchronize()
        want = chol.cholesky_rt_plain(a, bf16_updates=upd)
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        lower_zero = bool(torch.all(torch.tril(got, -1) == 0))
        resid = chol.blocked_residual(a, got, upd)
        rec = {"phase": "kernel", "kernel": "cholesky_rt", "case": name,
               "input": kind, "shape": [b, n, n],
               "dtype": str(dtype).split(".")[-1], "bf16_updates": upd,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance_vs_plain": tol_plain, "blocked_residual": resid,
               "plain_blocked_residual": chol.blocked_residual(a, want, upd),
               "tolerance_residual": tol, "strictly_lower_zero": lower_zero}
        if n >= 600 and kind == "dominant":
            a32 = a.float()
            rec["ms"] = cuda_ms(lambda: chol.cholesky_rt(a, upd), 3, 20)
            rec["plain_ms"] = cuda_ms(
                lambda: chol.cholesky_rt_plain(a, upd), 1, 3)
            rec["library_ms"] = cuda_ms(
                lambda: torch.linalg.cholesky(a32, upper=True), 3, 20)
            rec["bound_ms"], rec["bound_by"] = chol_bound_ms(
                b, n, a.element_size(), upd, chol.NB)
        emit(rec)
        if not (lower_zero and resid <= tol and rel_err <= tol_plain):
            raise RuntimeError(f"cholesky_rt {name}: rel err {rel_err} "
                               f"(tol {tol_plain}), blocked residual {resid} "
                               f"(tol {tol}), lower zero {lower_zero}")
        if name == "main_f32":
            main = rec
    return main


def phase_small_reference(torch):
    """The card's scores against the CPU plain path on a small model built
    from the same numpy seed (the port's own reference)."""
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    wavs = np.random.default_rng(5).uniform(-0.2, 0.2, (4, 8000)).astype(
        np.float32)
    enroll = np.random.default_rng(6).standard_normal((5, 16))
    scores = {}
    for dev in ("cpu", "cuda"):
        params = random_iv_plda_params(np.random.default_rng(99), 64, 72, 32,
                                       16, device=dev)
        model = IvPlda(params)
        model.set_enrollment([str(i) for i in range(5)], enroll)
        with torch.no_grad():
            scores[dev] = model.score(torch.tensor(wavs, device=dev)).cpu()
    err = float((scores["cuda"] - scores["cpu"]).abs().max())
    ok = bool(torch.allclose(scores["cuda"], scores["cpu"], rtol=1e-3,
                             atol=5e-3))
    emit({"phase": "small_reference", "max_abs_err": err,
          "tolerance": "rtol 1e-3, atol 5e-3", "ok": ok})
    if not ok:
        raise RuntimeError(f"card vs CPU scores differ by {err}")


def phase_slice(torch, chol, profile_dir):
    from speakerguard_tpu_torch.attacks import PGD
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    batch, length, n_spk, iters = 64, 48000, 10, 10
    t0 = time.perf_counter()
    params = random_iv_plda_params(np.random.default_rng(0), 2048, 72, 600,
                                   200, device="cuda")
    model = IvPlda(params)
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    with torch.no_grad():
        enroll = model.embedding(torch.tensor(enroll_wavs, device="cuda"))
    model.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # one short attack first, so the timed run below pays no first-use
    # costs (lazy module loading of the backward's kernels, allocator
    # growth, library handles)
    t0 = time.perf_counter()
    PGD(model, task="CSI", epsilon=0.002, step_size=0.0004, max_iter=1,
        loss="Entropy").attack(x, torch.zeros(batch, dtype=torch.long,
                                              device="cuda"), rng=0)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    chol.cholesky_rt.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        decisions, scores = model.make_decision(x)
    torch.cuda.synchronize()
    decide_s = time.perf_counter() - t0
    labels = decisions.long()
    atk = PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
              max_iter=iters, loss="Entropy")
    t0 = time.perf_counter()
    adver, success = atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    pgd_s = time.perf_counter() - t0
    launches = chol.cholesky_rt.launches
    plain_calls = chol.cholesky_rt.plain_calls
    expected = 1 + iters + 1  # make_decision + one per iteration + final

    finite = bool(torch.isfinite(scores).all() and torch.isfinite(adver).all())
    within = float((adver - x).abs().max()) <= 0.002 + 1e-6
    rec = {"phase": "slice", "model": "iv_plda", "task": "CSI-E",
           "C": 2048, "D": 72, "IV": 600, "R": 200, "speakers": n_spk,
           "batch": batch, "samples": length, "attack": "PGD",
           "iterations": iters, "setup_s": setup_s,
           "warmup_pgd1_s": warmup_s,
           "make_decision_s": decide_s, "pgd_s": pgd_s,
           "pgd_ms_per_iter": pgd_s * 1e3 / iters,
           "pgd_utts_per_s": batch / pgd_s,
           "asr_pct": 100.0 * sum(success) / batch,
           "scores_shape": list(scores.shape), "finite": finite,
           "within_eps": within,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "cholesky_rt_launches": launches,
           "cholesky_rt_expected": expected,
           "cholesky_rt_plain_calls": plain_calls}
    emit(rec)
    if not (finite and within and list(scores.shape) == [batch, n_spk]):
        raise RuntimeError(f"slice output check failed: {rec}")
    if launches != expected or plain_calls != 0:
        raise RuntimeError(f"cholesky_rt launches {launches}, plain calls "
                           f"{plain_calls}; expected {expected} launches")
    if profile_dir:
        profile_one_iteration(torch, model, x, labels, profile_dir)
    return launches


def profile_one_iteration(torch, model, x, labels, out_dir):
    from torch.profiler import ProfilerActivity, profile as tprofile
    from speakerguard_tpu_torch.attacks import PGD
    atk = PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
              max_iter=1, loss="Entropy")
    atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        atk.attack(x, labels, rng=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    table = events.table(row_limit=-1)
    # the table's footer sums kernel time once (per-op rows also carry the
    # time of the kernels they launch, so summing rows counts it twice)
    footer = [ln for ln in table.splitlines()
              if ln.startswith("Self CUDA time total:")]
    device_ms = parse_ms(footer[0].split(":")[1]) if footer else None

    def dev_us(e):  # the attribute was renamed across torch versions
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_pgd1.txt"), "w") as f:
        f.write(table)
    top = sorted(events, key=lambda e: -dev_us(e))
    emit({"phase": "profile", "iterations_profiled": 1,
          "note": "one PGD iteration plus the exact final evaluation; "
                  "wall time includes the profiler's own overhead",
          "wall_ms": wall_ms, "device_ms": device_ms,
          "device_busy_share": (device_ms / wall_ms if device_ms
                                else None),
          "top": [{"name": e.key[:60], "self_device_ms": dev_us(e) / 1e3,
                   "count": e.count} for e in top[:15]]})


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import speakerguard_tpu_torch  # noqa: F401  (turns TF32 off)
        from speakerguard_tpu_torch.ops import _build, chol
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    profile_dir = (argv[argv.index("--profile") + 1]
                   if "--profile" in argv else None)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = _build.build("chol")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})

    main_rec = phase_kernels(torch, chol)
    phase_small_reference(torch)
    launches = phase_slice(torch, chol, profile_dir)

    emit({"kernels": [{
        "name": "cholesky_rt", "route": "cuda",
        "source": "speakerguard_tpu_torch/csrc/chol.cu",
        "replaces": "speakerguard_tpu/ops/pallas_chol.py:489",
        "launches": launches, "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
