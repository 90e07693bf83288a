#!/usr/bin/env python3
"""Time each torch.linalg.svd driver on the card on Kenan ssa's trajectory
matrices, and check each one's result.

    python3 tools/ssa_svd_drivers.py [--waves 1] [--samples 48000]
        [--drivers default,gesvd,gesvda,gesvdj]

The waves are chip_smoke.py's slice_kenan_ssa_xv waves (numpy seed 1,
uniform in +-0.3, truncated to int16 as the attack truncates them); the
window is the attack's, min(0.05 N, 3000), 2400 at 3 s.  For each driver,
one line: the SVD's ms per wave (one call on the batch after one warm-up
call on a 64-sample-window matrix), the full reconstruction (keep = window)
against the input, the top 100 squared singular values against the float64
eigenvalues of the window x window Gram matrix, and the peak GiB.  A driver
that raises prints its error.  The drivers run in the order given, each
line printed when it ends.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--waves", type=int, default=1)
    p.add_argument("--samples", type=int, default=48000)
    p.add_argument("--drivers", default="default,gesvd,gesvda,gesvdj")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssa_svd_drivers: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    from speakerguard_tpu_torch.ops import ssa as ssa_mod
    rng = np.random.default_rng(1)
    rng.uniform(-0.3, 0.3, (10, args.samples))  # the enrollment waves
    x = rng.uniform(-0.3, 0.3, (args.waves, args.samples)).astype(np.float32)
    wav_i = torch.tensor((x.astype(np.float64) * 32768.0).astype(np.int16),
                         dtype=torch.float32, device="cuda")
    window = min(int(args.samples * 0.05), 3000)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "waves": args.waves,
                      "samples": args.samples, "window": window}),
          flush=True)
    for name in args.drivers.split(","):
        driver = None if name == "default" else name
        rec = {"driver": name}
        try:
            ssa_mod.ssa_device(wav_i[:1, :2000], 64, driver)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pc, s, v = ssa_mod.ssa_device(wav_i, window, driver)
            torch.cuda.synchronize()
            rec["svd_ms_per_wave"] = ((time.perf_counter() - t0) * 1e3
                                      / args.waves)
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            full = ssa_mod.inv_ssa_masked(pc, v, torch.full(
                (args.waves,), window, device="cuda"))
            rec["full_reconstruction_err_over_max"] = float(
                ((full - wav_i).abs().amax(1) / wav_i.abs().amax(1)).max())
            err = 0.0
            for i in range(args.waves):
                traj = ssa_mod.trajectory(wav_i[i:i + 1].double(),
                                          window)[0]
                eig = torch.linalg.eigvalsh(traj @ traj.mT).flip(0)[:100]
                err = max(err, float(((s[i, :100].double() ** 2 - eig).abs()
                                      / eig).max()))
            rec["top100_sv2_vs_f64_eig_max_rel_err"] = err
            rec["ok"] = (rec["full_reconstruction_err_over_max"] <= 1e-4
                         and err <= 1e-3)
            del pc, s, v, full
        except Exception as exc:  # noqa: BLE001 - report and go on
            rec["error"] = str(exc)[:300]
        torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
