"""Tracing and profiling helpers.

Port of speakerguard_tpu/utils/profiling.py:

  * ``trace(logdir)``   a ``torch.profiler.profile`` context (the host, and
                        the card when torch sees one) that writes a Chrome
                        trace into ``logdir`` on exit (view it in
                        chrome://tracing, Perfetto or TensorBoard).
  * ``annotate(name)``  ``torch.profiler.record_function``: a named span on
                        the trace's timeline.
  * ``StageTimer``      per-stage wall timers that wait for the device, in
                        the JAX package's report format.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Yields the profiler; its Chrome trace goes to ``logdir`` as
    ``<host>_<pid>.<timestamp>.pt.trace.json``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    return torch.profiler.record_function(name)


def _synchronize(tree):
    """Waits for every CUDA device that holds a tensor of ``tree`` (a
    tensor, or a list, tuple or dict nest of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class StageTimer:
    """Accumulating wall timers; a stage given ``sync`` waits for the
    device that holds it (JAX's ``block_until_ready``) so stage times are
    real.  Usage:

        t = StageTimer()
        with t.stage("forward", sync=out):
            out = model.score(x)
        print(t.report())

    ``sync`` is read when the stage ends: pass a tensor that exists before
    the stage, or a list the stage fills.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: total {tot:.3f}s over {n} calls "
                         f"({tot / n * 1000:.2f} ms/call)")
        return "\n".join(lines)
