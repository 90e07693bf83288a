"""The traced stretch: ``torch.profiler`` over a fixed count of calls, its
events kept in memory and reduced to what the per-layer readers need.

Device events are the card's kernels, copies and fills (CUPTI); host
events are the CPU-side operators and CUDA runtime calls.  Every time is
in nanoseconds on the profiler's clock; the stretch is the span of the
``bench.stretch`` annotation around the calls.
"""

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

STRETCH = "bench.stretch"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Event:
    name: str
    start: int
    end: int


@dataclass
class Trace:
    window: tuple            # (start, end) of the stretch, ns
    kernels: list = field(default_factory=list)   # device kernels
    copies: list = field(default_factory=list)    # device copies, fills
    host: list = field(default_factory=list)      # host operators, calls

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def device_events(self):
        return self.kernels + self.copies

    def busy_intervals(self) -> list:
        """The union of device intervals inside the stretch, sorted."""
        lo, hi = self.window
        spans = sorted((max(e.start, lo), min(e.end, hi))
                       for e in self.device_events()
                       if e.end > lo and e.start < hi)
        merged = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-9

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        operation running."""
        out, cur = [], self.window[0]
        for s, t in self.busy_intervals():
            if s > cur:
                out.append((cur, s))
            cur = max(cur, t)
        if self.window[1] > cur:
            out.append((cur, self.window[1]))
        return out

    def breakdown(self, top: int = 10, labelled: int = 2000) -> dict:
        """The device operations that took most time, and the idle gaps by
        what the host was doing (the innermost host event that covers the
        most of a gap), each summed by name.  The ``labelled`` longest gaps
        are labelled one by one, the rest summed as shorter gaps."""
        ops = {}
        for e in self.device_events():
            ops[e.name] = ops.get(e.name, 0) + (e.end - e.start)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        idle = {}
        if self.host:
            starts = np.array([e.start for e in self.host], dtype=np.int64)
            ends = np.array([e.end for e in self.host], dtype=np.int64)
            for s, t in gaps[:labelled]:
                cover = np.minimum(ends, t) - np.maximum(starts, s)
                best = int(np.argmax(cover))
                if cover[best] <= 0:
                    label = "host: no event"
                else:
                    # among the events of the best cover, the innermost
                    tied = np.flatnonzero(cover == cover[best])
                    label = self.host[int(tied[np.argmin(
                        (ends - starts)[tied])])].name
                idle[label] = idle.get(label, 0) + (t - s)
        else:
            for s, t in gaps[:labelled]:
                idle["host: no event"] = idle.get("host: no event", 0) + t - s
        rest = sum(t - s for s, t in gaps[labelled:])
        if rest:
            idle[f"shorter gaps ({len(gaps) - labelled})"] = rest

        def ranked(d):
            # demangled template names run to kilobytes: 200 characters
            # tell the kernels apart
            return [[k[:200], v * 1e-9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def _events(prof):
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        dur = getattr(e, "duration_ns", None)
        end = start + (int(dur()) if dur is not None
                       else int(e.duration_us() * 1000))
        note = getattr(e, "is_user_annotation", None)
        yield e.name(), e.device_type(), start, end, bool(note and note())


@contextlib.contextmanager
def stretch(holder: list):
    """Profiles the body; on exit appends its ``Trace`` to ``holder``."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    window, kernels, copies, host = None, [], [], []
    for name, dev, start, end, note in _events(prof):
        if name == STRETCH:
            # the annotation's host span is the stretch; its device-side
            # copy (a user annotation on the card's timeline) is no work
            if dev != torch.autograd.DeviceType.CUDA:
                window = (start, end)
        elif note and dev == torch.autograd.DeviceType.CUDA:
            continue
        elif dev == torch.autograd.DeviceType.CUDA:
            (copies if name.startswith(COPY_PREFIXES) else kernels).append(
                Event(name, start, end))
        else:
            host.append(Event(name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no stretch annotation")
    holder.append(Trace(window=window, kernels=kernels, copies=copies,
                        host=host))
