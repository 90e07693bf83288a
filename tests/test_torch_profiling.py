"""The port's tracing helpers (speakerguard_tpu_torch/utils/profiling.py)
against the JAX package's (speakerguard_tpu/utils/profiling.py): ``trace``
writes a trace file, ``annotate`` names a span in it, and ``StageTimer``
counts, orders and reports its stages as JAX's does."""

import glob
import json
import os
import time

import torch

from speakerguard_tpu.utils.profiling import StageTimer as JaxStageTimer

from speakerguard_tpu_torch.utils.profiling import (StageTimer, annotate,
                                                    trace)

from test_torch_kenan import one_cpu_thread  # noqa: F401


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("my_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_stage" for e in events)


def _drive(timer, sync):
    for name, pause, n in (("short", 0.001, 3), ("long", 0.02, 2)):
        for _ in range(n):
            with timer.stage(name, sync=sync):
                time.sleep(pause)


def test_stage_timer_counts_and_orders_like_jax():
    port, jax_timer = StageTimer(), JaxStageTimer()
    _drive(port, torch.zeros(3))
    _drive(jax_timer, None)
    assert dict(port.counts) == dict(jax_timer.counts) == {"short": 3,
                                                           "long": 2}
    lines = port.report().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        ln.split(":")[0] for ln in jax_timer.report().splitlines()] == [
        "long", "short"]
    total = port.totals["long"]
    assert total >= 0.04
    assert lines[0] == (f"long: total {total:.3f}s over 2 calls "
                        f"({total / 2 * 1000:.2f} ms/call)")
