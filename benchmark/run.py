"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; then ``checks``, every compared number beside its
limit, which are also the last lines of standard error.  Without the cards,
or when a module of JAX or of the JAX package is loaded once the window
has closed, it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()   # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it (a roofline share is
    against the 700 W peak)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = harness.part("drivers", cell.traffic["driver"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     T_START, device)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        tr = out["trace"]
        ctx = SimpleNamespace(trace=tr, **out["context"])
        values = {m["name"]: harness.part("metrics", m["name"]).read(ctx)
                  for m in cell.per_layer}
        result["metrics"] = harness.select_metrics(cell.per_layer, values)
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s,
                   power_limit=power_limit())
        result["device"] = dev
        result["breakdown"] = tr.breakdown()
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if out["values"].get(m["name"]) is None]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
        result["metrics"] = harness.select_metrics(cell.end_to_end,
                                                   out["values"])
        result["device"] = dev
    result["checks"] = checks
    print(f"calls {out['attempted'] // cell.traffic['batch']}, window "
          f"{out['window_s']:.3f} s, judged in {out['judge_s']:.3f} s",
          file=sys.stderr)
    print(harness.checks_text(checks), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
