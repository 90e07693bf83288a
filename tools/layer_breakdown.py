"""Per-layer breakdown of a benchmark cell's traced calls: for each layer
of the program's spans (``benchmark/spans.py``), its device ms, idle ms
and kernels a call, its device ops that took most time, and the host ops
(a backward op by its autograd node) whose launches ended its longest
idle time: what the card waited for.

    python3 tools/layer_breakdown.py --workload NAME [--seed N] [--top 6]

From the root of a checkout, on the card the cell asks for.  The cell's
program, inputs and warm-up are the benchmark's own
(``drivers/attack_campaign.py``); its ``trace_calls`` calls then run under
``spans.stretch``, as a ``--trace 1`` run puts them under
``trace.stretch``.  The outputs are not judged.  Prints one JSON line.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness, spans  # noqa: E402


def record(cell, seed: int, device):
    """The traced calls of ``cell`` on ``device`` -> (trace, calls)."""
    cfg, traffic = cell.config, cell.traffic
    drv = harness.part("drivers", traffic["driver"])
    drv.check_attack(traffic["attack"])
    models = harness.part("models", cfg["model"])
    campaign = drv.Campaign(seed, cfg, traffic, device)
    atk = drv.ProgramAttack(models.build_program(
        models.make_weights(cfg, harness.derive_seed(seed, "weights"),
                            device), cfg, traffic["program"], device),
        traffic, campaign)
    drv.run_calls(atk, campaign, -traffic["warmup_calls"],
                  calls=traffic["warmup_calls"])
    holder = []
    with spans.stretch(holder):
        outputs, _, _ = drv.run_calls(atk, campaign, 0,
                                      calls=traffic["trace_calls"])
    return holder[0], len(outputs)


def _top(d: dict, top: int, calls: int) -> list:
    return [[k[:120], v * 1e-6 / calls] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(tr, calls: int, top: int) -> dict:
    layers = spans.attribute(tr)
    return {
        "coverage_pct": spans.coverage_pct(layers),
        "spans_a_call": sum(e.name.startswith(spans.SPAN)
                            for e in tr.host) / calls,
        "layers": {str(k): {"device_ms": d.device_ns * 1e-6 / calls,
                            "idle_ms": d.idle_ns * 1e-6 / calls,
                            "kernels": d.kernels / calls,
                            "top_ops_ms": _top(d.ops, top, calls),
                            "waited_for_ms": _top(d.waited_for, top, calls)}
                   for k, d in sorted(layers.items(),
                                      key=lambda kv: str(kv[0]))}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 11)
    p.add_argument("--top", type=int, default=6)
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available():
        sys.exit(f"{a.workload} needs a CUDA card")
    device = torch.device("cuda", 0)
    tr, calls = record(cell, a.seed, device)
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "calls": calls,
                      "device": torch.cuda.get_device_name(device),
                      "busy_s": tr.busy_s(), "window_s": tr.window_s,
                      **breakdown(tr, calls, a.top)}), flush=True)


if __name__ == "__main__":
    main()
