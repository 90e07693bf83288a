#!/usr/bin/env python3
"""The ADPCM kernel, the ADPCM defense and slice_defended_adpcm_xv's PGD
iteration on one card, for comparing two checkouts of the port in turns.

    python3 tools/adpcm_rounds.py [--root DIR] [--rounds N]

Imports ``speakerguard_tpu_torch`` from DIR (default: the checkout holding
this script) and builds its ``csrc/adpcm.cu`` there, so one copy of the
script times an older checkout too: run it with the parent's DIR and this
one's in turns (parent, change, change, parent) inside one call to the
card.  CUDA events after two warm-up calls, ten calls timed:

- ``adpcm(x16, 4)`` at 512 x 48,000 and 512 x 4,800: chip_smoke.py's codec
  batch (uniform in [-0.6, 0.6] from numpy seed 8, scaled to int16 and
  clamped), with the kernel's cycles a sample at the card's highest SM
  clock and a SHA-256 of its 512 x 48,000 output (equal across checkouts
  when both are bit-exact);
- the ``ADPCM`` defense, ``SC.ADPCM(x, 4)``, on the same batch in the scale
  domain;
- chip_smoke.py's ``slice_defended_adpcm_xv``: xv-PLDA (weights from numpy
  seed 0, ``FastPath()``), 10 speakers enrolled from waves (seed 1), ADPCM
  4 @0 before the model, 512 waves of 3 s; make_decision gives the labels,
  one PGD-1 warm-up, then N runs of PGD-10 (eps 0.002, step 0.0004,
  Entropy, EOT 1, rng 0), host clock around each with a synchronise.

Prints one JSON line: the card and its power limit, the times, ms per
PGD iteration of each run, the success vector of the first run and
adpcm's launches in it.  Exits non-zero without a card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np


def cuda_ms(torch, fn, warmup=2, iters=10):
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


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("adpcm_rounds: no CUDA card visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import speakerguard_tpu_torch  # noqa: F401  (TF32 off)
    from speakerguard_tpu_torch.attacks import PGD
    from speakerguard_tpu_torch.defenses import speech_compression as SC
    from speakerguard_tpu_torch.defenses.registry import parser_defense
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.defended import DefendedModel
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    from speakerguard_tpu_torch.ops import adpcm as A

    def query(field):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    smi = query("name,power.limit")
    clock_mhz = float(query("clocks.max.sm").split()[0])
    rec = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "sm_clock_max_mhz": clock_mhz}

    # the kernel and the defense at chip_smoke.py's codec batch
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.uniform(-0.6, 0.6, (512, 48000)).astype(np.float32),
                     device="cuda")
    x16 = torch.clamp(x * 32768.0, -32768.0, 32767.0)
    short = x16[:, :4800].contiguous()
    out = A.adpcm(x16, 4)
    torch.cuda.synchronize()
    rec["out_sha256"] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    rec["kernel_ms"] = cuda_ms(torch, lambda: A.adpcm(x16, 4))
    rec["kernel_ms_512x4800"] = cuda_ms(torch, lambda: A.adpcm(short, 4))
    rec["cycles_per_sample"] = rec["kernel_ms"] * 1e-3 * clock_mhz * 1e6 / 48000
    rec["defense_ms"] = cuda_ms(torch, lambda: SC.ADPCM(x, 4))
    del x, x16, short, out
    torch.cuda.empty_cache()

    # slice_defended_adpcm_xv
    n_spk, length, batch, iters = 10, 48000, 512, 10
    params = random_xv_plda_params(np.random.default_rng(0), device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    with torch.no_grad():
        enroll = XvPlda(params, fast=FastPath(enabled=False)).embedding(
            torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    base = XvPlda(params, fast=FastPath())
    base.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
    defense, _ = parser_defense(["ADPCM"], ["4"], [0], "sequential")
    model = DefendedModel(base, defense, "sequential")

    def pgd(n):
        return PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
                   max_iter=n, loss="Entropy", EOT_size=1)

    pgd(1).attack(x, torch.zeros(batch, dtype=torch.long, device="cuda"),
                  rng=1)
    with torch.no_grad():
        labels = model.make_decision(x)[0].long()
    ms, success, launches = [], None, None
    for r in range(args.rounds):
        A.adpcm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, succ = pgd(iters).attack(x, labels, rng=0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / iters)
        if r == 0:
            success = [int(s) for s in succ]
            launches = A.adpcm.launches
    rec.update({"slice": "slice_defended_adpcm_xv", "iterations": iters,
                "pgd_ms_per_iter": ms, "asr_pct": 100.0 * sum(success) / batch,
                "success": success, "adpcm_launches": launches})
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
