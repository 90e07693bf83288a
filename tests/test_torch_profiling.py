"""The port's tracing helpers (speakerguard_tpu_torch/utils/profiling.py):
``trace`` writes a trace file, ``annotate`` names a span in it, and a
backward node in the file names the forward op that made it."""

import glob
import json
import os

import torch

from speakerguard_tpu_torch.utils.profiling import annotate, trace

from test_torch_kenan import one_cpu_thread  # noqa: F401


def _chrome_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("my_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e["name"] == "my_stage" for e in _chrome_events(logdir))


def test_trace_file_links_backward_to_forward_by_sequence_number(tmp_path):
    x = torch.randn(8, 8, requires_grad=True)
    with trace(str(tmp_path)):
        with annotate("sg.a"):
            y = torch.tanh(x @ x)
        with annotate("sg.b"):
            loss = (y * 3).sum()
        loss.backward()
    events = _chrome_events(str(tmp_path))
    spans = {e["name"]: e for e in events if e["name"].startswith("sg.")}
    forward = {}
    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        if seq is not None and not e["args"].get("Fwd thread id"):
            if seq not in forward or e["ts"] >= forward[seq]["ts"]:
                forward[seq] = e

    def span_of(e):
        return [n for n, s in spans.items()
                if s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]

    layers = {}
    for e in events:
        if e["name"].startswith("autograd::engine::evaluate_function: "):
            args = e["args"]
            if args.get("Fwd thread id"):
                op = forward[args["Sequence number"]]
                layers[e["name"].split(": ")[1]] = span_of(op)
    assert layers == {"SumBackward0": ["sg.b"], "MulBackward0": ["sg.b"],
                      "TanhBackward0": ["sg.a"], "MmBackward0": ["sg.a"]}
