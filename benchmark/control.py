"""Readings that set a cell's limits: the program on many seeds, its
control, and planted faults, each a short campaign at the cell's own
size, judged as a run judges it.  One JSON line per run.

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 \
        [--modes sound,control,unchanged,half,answer] [--calls N]

sound       the program as the cell runs it (the lower readings)
control     the plain reference computed at TF32, the step below the
            float32 the configurations state, in the program's place
unchanged, half, answer
            the faults of ``faults.py`` planted in the program

Not part of a benchmark run; run on the card (the control needs TF32,
which the CPU does not have).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MODES = ("sound", "control", "unchanged", "half", "answer")


def readings(cell, seeds, modes, calls, device):
    """Yields one record per (mode, seed)."""
    from benchmark import faults, harness
    driver = harness.part("drivers", cell.traffic["driver"])
    for mode in modes:
        for seed in seeds:
            planted = (faults.planted(mode) if mode in faults.FAULTS
                       else contextlib.nullcontext())
            t0 = time.perf_counter()
            with planted:
                out = driver.run(cell, seed, None, False, t0, device,
                                 mode="control" if mode == "control"
                                 else "program", calls=calls)
            yield {"workload": cell.name, "mode": mode, "seed": seed,
                   "calls": calls, "attempted": out["attempted"],
                   "failed": out["failed"],
                   "correct": all(c["value"] <= c["limit"]
                                  for c in out["checks"].values()),
                   "checks": out["checks"],
                   "rate": out["values"]["attack_utts_per_s"],
                   "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--calls", type=int, default=None,
                   help="window calls a run (default: the mix's "
                        "control_calls)")
    args = p.parse_args(argv)
    from benchmark import harness
    import torch
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control.py runs on a CUDA card", file=sys.stderr)
        return 2
    calls = args.calls or cell.traffic["control_calls"]
    for rec in readings(cell, [int(s) for s in args.seeds.split(",")],
                        args.modes.split(","), calls,
                        torch.device("cuda", 0)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
