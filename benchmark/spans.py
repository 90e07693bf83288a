"""The program's layers in a traced stretch: each device event, and each
idle gap, put down to the layer of the program's span (``sg.<layer>``,
``speakerguard_tpu_torch/utils/profiling.annotate``) that launched it.

A device event (kernel, copy or fill) belongs to the host op that launched
it: the op whose id is the event's ``linked`` id, else the runtime call
that shares its CUPTI ``correlation``.  Where that op runs inside an
autograd node (an ``autograd::engine::evaluate_function`` event), the node
names its forward op by (``fwd_thread``, ``sequence``), and the layer is
the innermost span that holds that forward op; a node with no forward op
(the graph root, ``AccumulateGrad``) takes the span that its calling
thread was in at that moment.  Elsewhere the layer is the innermost span
that holds the op on its own thread.  The ``sg.pgd.*`` spans are the
attack loop's: the loss, sign, clip, EOT means and vote outside the
model's spans.  An idle gap goes to the layer of the device event that
ends it (the card waited for that launch); the gap at the window's tail
to none.

``trace.stretch`` keeps no links, and the benchmark's files stay as they
are outside a ``benchmark`` change: ``stretch`` here records the same
``trace.Trace`` with each event's links kept (``Event``).  Read by
``tools/layer_breakdown.py``; no metric of ``BENCHMARK.json`` reads it yet
(``PERF.md`` §7 says what would wire it in).
"""

import contextlib
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import trace

SPAN = "sg."
EVALUATE = "autograd::engine::evaluate_function"
CALL = "cu"   # a host event so named is a CUDA runtime or driver call


@dataclass
class Event(trace.Event):
    """A traced event with what links it to others (None where the
    profiler gives none)."""
    thread: int | None = None      # the profiler's id of the host thread
    correlation: int | None = None  # a host op's own id; CUPTI's on a
    #                                 device event and its runtime call
    linked: int | None = None      # device event: the launching op's id
    sequence: int | None = None    # autograd sequence number (-1: none)
    fwd_thread: int | None = None  # backward op: its forward op's thread


def _event(e, name, start, end) -> Event:
    return Event(name, start, end, thread=e.start_thread_id(),
                 correlation=e.correlation_id(),
                 linked=e.linked_correlation_id(), sequence=e.sequence_nr(),
                 fwd_thread=e.fwd_thread_id())


@contextlib.contextmanager
def stretch(holder: list):
    """``trace.stretch`` with links: profiles the body, and on exit
    appends its ``trace.Trace`` of ``Event``s to ``holder``."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.STRETCH):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    window, kernels, copies, host = None, [], [], []
    for e, (name, dev, start, end, note) in zip(
            prof.profiler.kineto_results.events(), trace._events(prof)):
        if name == trace.STRETCH:
            if dev != cuda:
                window = (start, end)
        elif note and dev == cuda:
            continue
        elif dev == cuda:
            (copies if name.startswith(trace.COPY_PREFIXES)
             else kernels).append(_event(e, name, start, end))
        else:
            host.append(_event(e, name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no stretch annotation")
    holder.append(trace.Trace(window=window, kernels=kernels, copies=copies,
                              host=host))


def layer_of(span: str) -> str:
    """``sg.pgd.iter`` -> ``attack_loop``, ``sg.tdnn`` -> ``tdnn``."""
    rest = span[len(SPAN):]
    return "attack_loop" if rest.startswith("pgd.") else rest


class Innermost:
    """The innermost of one thread's nested intervals at a time: the
    intervals flattened into segments over which it does not change."""

    def __init__(self, intervals):
        """``intervals``: (start, end, value) that nest or do not meet."""
        self.times, self.values = [], []
        open_ = []                     # (end, value), innermost last
        for s, e, v in sorted(intervals, key=lambda x: (x[0], -x[1])):
            self._close(open_, s)
            open_.append((e, v))
            self.times.append(s)
            self.values.append(v)
        self._close(open_, float("inf"))

    def _close(self, open_, until):
        while open_ and open_[-1][0] <= until:
            end, _ = open_.pop()
            self.times.append(end)
            self.values.append(open_[-1][1] if open_ else None)

    def at(self, t):
        i = bisect_right(self.times, t) - 1
        return self.values[i] if i >= 0 else None


def _by_thread(events):
    out = {}
    for e in events:
        out.setdefault(e.thread, []).append((e.start, e.end, e))
    return {k: Innermost(v) for k, v in out.items()}


class _Resolver:
    """Finds the layer of a device event from the trace's host events."""

    def __init__(self, host):
        spans = [e for e in host if e.name.startswith(SPAN)]
        self.layers = {layer_of(e.name) for e in spans}
        self.spans = _by_thread(spans)
        self.nodes = _by_thread(e for e in host
                                if e.name.startswith(EVALUATE))
        self.ops, self.calls, self.forward = {}, {}, {}
        for e in host:
            if e.name.startswith(CALL):
                self.calls[e.correlation] = e
            elif not e.name.startswith((SPAN, EVALUATE)):
                if e.correlation:
                    self.ops[e.correlation] = e
                if (e.sequence is not None and e.sequence >= 0
                        and not e.fwd_thread):
                    # of the ops that read one sequence number, the last
                    # to start made the node (the others hold it)
                    key = (e.thread, e.sequence)
                    if key not in self.forward or \
                            e.start >= self.forward[key].start:
                        self.forward[key] = e

    def span_at(self, thread, t, any_thread=True):
        """The innermost span at ``t`` on ``thread``; else, with
        ``any_thread``, the innermost on any other thread."""
        own = self.spans.get(thread)
        hit = own.at(t) if own is not None else None
        if hit is not None or not any_thread:
            return hit
        held = [s for k, s in ((k, v.at(t)) for k, v in self.spans.items()
                               if k != thread) if s is not None]
        return max(held, key=lambda s: s.start) if held else None

    def launch(self, dev):
        """(the host op, or else the runtime call, that launched ``dev``;
        the autograd node it ran in, or None)."""
        op = self.ops.get(dev.linked) if dev.linked else None
        if op is None and dev.correlation is not None:
            op = self.calls.get(dev.correlation)
        if op is None:
            return None, None
        tree = self.nodes.get(op.thread)
        return op, tree.at(op.start) if tree is not None else None

    def layer(self, op, node):
        """The layer of a launch by ``op`` inside ``node``."""
        if op is None:
            return None
        span = None
        if node is not None and node.fwd_thread:
            fwd = self.forward.get((node.fwd_thread, node.sequence))
            if fwd is not None:
                span = self.span_at(fwd.thread, fwd.start, any_thread=False)
        if span is None:
            span = self.span_at(op.thread, op.start)
        return None if span is None else layer_of(span.name)


@dataclass
class Layer:
    """What one layer took of a stretch, in ns."""
    device_ns: int = 0
    idle_ns: int = 0
    kernels: int = 0
    ops: dict = field(default_factory=dict)         # device op -> ns
    waited_for: dict = field(default_factory=dict)  # launch -> idle ns


def attribute(tr) -> dict:
    """{layer: Layer} of the trace ``tr`` (events with links); the key
    None holds what no span takes.  Every layer with a span in the trace
    has an entry.  Device time is each device event's duration inside the
    window; a gap's ``waited_for`` names its ending event's launching op,
    or, for a backward launch, the autograd node."""
    lo, hi = tr.window
    res = _Resolver(tr.host)
    out = {layer: Layer() for layer in res.layers}
    kernels = {id(e) for e in tr.kernels}
    rows = []                         # (clipped start, layer, launch name)
    for e in tr.device_events():
        if e.end <= lo or e.start >= hi:
            continue
        op, node = res.launch(e)
        layer = res.layer(op, node)
        s, t = max(e.start, lo), min(e.end, hi)
        d = out.setdefault(layer, Layer())
        d.device_ns += t - s
        d.kernels += id(e) in kernels
        d.ops[e.name] = d.ops.get(e.name, 0) + (t - s)
        what = (node.name.split(": ")[-1] if node is not None
                else op.name if op is not None else "no launching op")
        rows.append((s, layer, what))
    rows.sort(key=lambda r: r[0])
    times = [r[0] for r in rows]
    for s, t in tr.gaps():
        if t >= hi:
            continue                  # the tail: nothing ends it
        # the first event to start where the gap ends
        _, layer, what = rows[bisect_left(times, t)]
        d = out[layer]
        d.idle_ns += t - s
        d.waited_for[what] = d.waited_for.get(what, 0) + (t - s)
    return out


def coverage_pct(layers: dict) -> float:
    """The share of the device time of ``attribute``'s result that some
    layer takes."""
    total = sum(d.device_ns for d in layers.values())
    rest = layers[None].device_ns if None in layers else 0
    return 100.0 * (total - rest) / total if total else 0.0
