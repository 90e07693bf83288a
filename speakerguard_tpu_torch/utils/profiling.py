"""Tracing helpers.

Port of speakerguard_tpu/utils/profiling.py:

  * ``trace(logdir)``   a ``torch.profiler.profile`` context (the host, and
                        the card when torch sees one) that writes a Chrome
                        trace into ``logdir`` on exit (view it in
                        chrome://tracing, Perfetto or TensorBoard).
  * ``annotate(name)``  a named span on the timeline of the profiler that
                        the caller runs (``trace`` here, or any other
                        ``torch.profiler.profile``), on its clock; with no
                        profiler recording, a shared null context that
                        costs one check.

The program opens its spans only through ``annotate``.  The attack path's
spans are named ``sg.<layer>``; ``benchmark/spans.py`` puts each device
event down to the innermost such span of the host op that launched it, and
a backward op to the span of the forward op that made its autograd node
(the node's forward thread and sequence number).
"""

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


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
    """``torch.profiler.record_function(name)`` while a profiler records,
    else the shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
