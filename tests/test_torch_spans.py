"""The attack path's layer spans (utils/profiling.annotate) on the CPU, on
the small xv and iv fixtures' weights (tests/test_torch_xv_plda.py,
tests/test_torch_iv_plda.py: the same draws, made by the port's own
``random_*_params``): with the profiler off ``annotate`` is one shared null
context and PGD-2 computes bit for bit what it computes under the
profiler; under it the spans nest as the layers do, every forward op that
reads an autograd sequence number lies in one layer, and every backward
node names such a forward op by (forward thread, sequence number)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speakerguard_tpu_torch.attacks import PGD
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                   random_iv_plda_params)
from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                   random_xv_plda_params)
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC, XV_PLDA_MFCC
from speakerguard_tpu_torch.utils.profiling import annotate

EVALUATE = "autograd::engine::evaluate_function: "
MODEL_SPANS = ("sg.frontend", "sg.tdnn", "sg.gmm_stats", "sg.ivector",
               "sg.plda")
ITERS = 2


def _xv():
    rng = np.random.default_rng(1234)
    params = random_xv_plda_params(rng, device="cpu")
    m = XvPlda(params, mfcc_config=dataclasses.replace(XV_PLDA_MFCC,
                                                       dither=0.0),
               fast=FastPath())
    m.set_enrollment([str(i) for i in range(5)],
                     rng.standard_normal((5, 150)).astype(np.float32))
    return m, 16000


def _iv(**kw):
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=32, reduced_dim=16,
                                   device="cpu")
    m = IvPlda(params, mfcc_config=dataclasses.replace(IV_PLDA_MFCC,
                                                       dither=0.0), **kw)
    m.set_enrollment([str(i) for i in range(5)],
                     rng.standard_normal((5, 16)).astype(np.float32))
    return m, 8000


# the cells' paths: iv's default selects the top K of 64 components (its
# 256 would select them all, and then no context is built)
CELLS = {
    "xv": _xv,
    "iv": lambda: _iv(fast=FastPath(gmm_topk=16)),
    "iv_gmmk": lambda: _iv(fast=FastPath(gmm_topk=0, stats_kernel=True),
                           loglike_kernel=True),
}

# each model evaluation's spans, the context's, and the layers that
# backward nodes reach
SCORE = {"xv": ["sg.frontend", "sg.tdnn", "sg.plda", "sg.plda"],
         "iv": ["sg.frontend", "sg.gmm_stats", "sg.ivector", "sg.plda",
                "sg.plda"]}
CONTEXT = {"xv": [], "iv": ["sg.frontend", "sg.gmm_stats", "sg.ivector"],
           "iv_gmmk": []}


def _attack(model, length):
    x = np.random.default_rng(7).uniform(-0.25, 0.25, (3, length))
    return PGD(model, epsilon=0.002, step_size=0.0004, max_iter=ITERS).attack(
        x.astype(np.float32), np.array([0, 3, 4]))


@pytest.fixture(scope="module")
def runs():
    """{cell: (plain run, profiled run, the profile's host events)}."""
    out = {}
    for name, make in CELLS.items():
        model, length = make()
        plain = _attack(model, length)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = _attack(model, length)
        out[name] = (plain, traced,
                     list(prof.profiler.kineto_results.events()))
    return out


def _spans(events):
    return [e for e in events if e.name().startswith("sg.")]


def _holds(outer, inner):
    return (outer.start_thread_id() == inner.start_thread_id()
            and outer.start_ns() <= inner.start_ns()
            and inner.start_ns() + inner.duration_ns()
            <= outer.start_ns() + outer.duration_ns())


def _tree(spans):
    """The spans as nested [name, [children]] lists, in order."""
    roots, stack = [], []
    for s in sorted(spans, key=lambda s: (s.start_ns(), -s.duration_ns())):
        while stack and not _holds(stack[-1][0], s):
            stack.pop()
        node = [s.name(), []]
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((s, node))
    return roots


def _expected(cell):
    score = [[n, []] for n in SCORE[cell.split("_")[0]]]
    return [["sg.pgd.call", [
        ["sg.pgd.context", [[n, []] for n in CONTEXT[cell]]],
        *[["sg.pgd.iter", score] for _ in range(ITERS)],
        ["sg.pgd.final", score]]]]


def _forward_ops(events):
    return [e for e in events
            if e.sequence_nr() >= 0 and not e.fwd_thread_id()
            and not e.name().startswith(("sg.", "autograd::"))]


def test_annotate_is_the_shared_null_context_with_the_profiler_off():
    assert annotate("sg.a") is annotate("sg.b")
    assert isinstance(annotate("sg.a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        on = annotate("sg.a")
    assert not isinstance(on, contextlib.nullcontext)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_spans_change_no_bit_of_pgd(runs, cell):
    (adv, success), (adv_t, success_t), _ = runs[cell]
    assert torch.equal(adv, adv_t)
    assert success == success_t


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_span_nesting_matches_the_layers(runs, cell):
    assert _tree(_spans(runs[cell][2])) == _expected(cell)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_forward_op_lies_in_one_layer(runs, cell):
    events = runs[cell][2]
    spans = _spans(events)
    ops = _forward_ops(events)
    assert len(ops) > 100
    for op in ops:
        held = [s.name() for s in spans if _holds(s, op)]
        assert "sg.pgd.call" in held, op.name()
        assert len([n for n in held if n in MODEL_SPANS]) <= 1, (
            op.name(), held)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_backward_node_names_a_forward_op(runs, cell):
    events = runs[cell][2]
    spans = _spans(events)
    last = {}
    for op in _forward_ops(events):
        key = (op.start_thread_id(), op.sequence_nr())
        if key not in last or op.start_ns() >= last[key].start_ns():
            last[key] = op
    nodes = [e for e in events if e.name().startswith(EVALUATE)]
    assert len(nodes) > 50
    reached = set()
    for node in nodes:
        op = last.get((node.fwd_thread_id(), node.sequence_nr()))
        if op is None:
            assert node.name()[len(EVALUATE):] in (
                "torch::autograd::AccumulateGrad",
                "torch::autograd::GraphRoot"), node.name()
            continue
        inner = max((s for s in spans if _holds(s, op)),
                    key=lambda s: s.start_ns())
        reached.add(inner.name())
    layers = set(SCORE[cell.split("_")[0]]) | {"sg.pgd.iter"}
    assert reached == layers
