#!/usr/bin/env python3
"""ms per PGD iteration of the port's iv-PLDA slices on one card, for
comparing two checkouts of the port in turns.

    python3 tools/torch_pgd_rounds.py [--root DIR] [--rounds N]
                                      [--slice NAME ...]

Imports ``speakerguard_tpu_torch`` from DIR (default: the checkout holding
this script), so one copy of the script times an older checkout too: run
it with the parent's DIR and this one's in turns (parent, change, change,
parent) inside one call to the card.  The model and attack are
chip_smoke.py's: iv-PLDA (C=2048, D=72, IV=600, R=200; weights from numpy
seed 0), 10 enrolled speakers, 64 utterances of 3 s; make_decision, one
PGD-1 warm-up, then N runs of PGD-10 (eps 0.002, step 0.0004, Entropy).
``--slice`` picks chip_smoke.py's slices by name (repeatable; default
``slice_fast_kernels``): ``slice_fast_kernels`` (``FastPath(gmm_topk=0,
stats_kernel=True)``, ``loglike_kernel=True``), ``slice_fast_default``
(``FastPath()``), ``slice_chol_dinv`` and ``slice_chol_solve``
(``FastPath()`` with ``spd_solver`` ``"cholesky_rt_dinv"`` or
``"chol_solve"``).  Prints one JSON line per slice: ms per iteration of
each run, the peak device memory of the first run, its attack success per
sample and the kernels' launch counts in it.  Exits non-zero without a
card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--slice", action="append", choices=(
        "slice_fast_kernels", "slice_fast_default", "slice_chol_dinv",
        "slice_chol_solve"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_pgd_rounds: no CUDA card visible to torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import speakerguard_tpu_torch  # noqa: F401  (TF32 off)
    from speakerguard_tpu_torch.attacks import PGD
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    from speakerguard_tpu_torch.ops import chol, gmm_loglike, gmm_stats

    batch, length, n_spk, iters = 64, 48000, 10, 10
    params = random_iv_plda_params(np.random.default_rng(0), 2048, 72, 600,
                                   200, device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    exact = IvPlda(params, fast=FastPath(enabled=False))
    exact.set_enrollment([f"spk{i}" for i in range(n_spk)],
                         np.zeros((n_spk, 200), np.float32))
    with torch.no_grad():
        enroll = exact.embedding(torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    # slice: (FastPath, loglike_kernel, spd_solver)
    slices = {
        "slice_fast_kernels": (FastPath(gmm_topk=0, stats_kernel=True), True,
                               "cholesky_rt"),
        "slice_fast_default": (FastPath(), False, "cholesky_rt"),
        "slice_chol_dinv": (FastPath(), False, "cholesky_rt_dinv"),
        "slice_chol_solve": (FastPath(), False, "chol_solve")}
    wrappers = {"cholesky_rt": chol.cholesky_rt,
                "cholesky_rt_dinv": chol.cholesky_rt_dinv,
                "chol_solve": chol.chol_solve,
                "fused_loglike": gmm_loglike.fused_loglike,
                "stats_fwd": gmm_stats.stats_fwd,
                "stats_bwd": gmm_stats.stats_bwd}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for name in args.slice or ["slice_fast_kernels"]:
        fast, loglike_kernel, solver = slices[name]
        model = IvPlda(params, fast=fast, loglike_kernel=loglike_kernel,
                       spd_solver=solver)
        model.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
        with torch.no_grad():
            labels = model.make_decision(x)[0].long()

        def attack(n):
            return PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
                       max_iter=n, loss="Entropy").attack(x, labels, rng=0)

        attack(1)
        torch.cuda.synchronize()
        ms, success, peak, launches = [], None, None, None
        for r in range(args.rounds):
            for w in wrappers.values():
                w.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, succ = attack(iters)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / iters)
            if r == 0:
                success = [bool(s) for s in succ]
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                launches = {k: w.launches for k, w in wrappers.items()}
        print(json.dumps({
            "root": os.path.abspath(args.root), "slice": name,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "iterations": iters, "ms_per_iter": ms, "peak_mem_gib": peak,
            "asr_pct": 100.0 * sum(success) / batch, "success": success,
            "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
