"""What one program span costs the host: ``utils/profiling.annotate`` with
no profiler recording (the gate alone), and under ``torch.profiler`` with
the activities the benchmark's traced runs record (the CPU and, where
torch sees one, the card), each less an empty loop's time.

    python3 tools/span_cost.py [--n 20000] [--repeats 7]

Prints one JSON line: the median ns a span each way over the repeats, and
the card's name and power limit where there is one.  A traced call's
spans cost the spans a call (``PERF.md``) times the profiled figure.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from speakerguard_tpu_torch.utils.profiling import annotate  # noqa: E402


def _loop_ns(n: int, spans: bool) -> float:
    t0 = time.perf_counter_ns()
    if spans:
        for _ in range(n):
            with annotate("sg.cost"):
                pass
    else:
        for _ in range(n):
            pass
    return time.perf_counter_ns() - t0


def span_ns(n: int, repeats: int, profiled: bool) -> float:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = []
    for _ in range(repeats):
        empty = _loop_ns(n, False)
        if profiled:
            with profile(activities=acts):
                spans = _loop_ns(n, True)
        else:
            spans = _loop_ns(n, True)
        out.append((spans - empty) / n)
    return statistics.median(out)


def card() -> dict:
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": q.stdout.strip().splitlines()[:1]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--repeats", type=int, default=7)
    a = p.parse_args(argv)
    print(json.dumps({"n": a.n, "repeats": a.repeats,
                      "off_ns": span_ns(a.n, a.repeats, False),
                      "profiled_ns": span_ns(a.n, a.repeats, True),
                      **card()}), flush=True)


if __name__ == "__main__":
    main()
