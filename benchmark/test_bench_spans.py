"""The layer attribution (``spans.py``) on synthetic traces, and its
recorder on recorded ones: the existing readers read the same from a
trace whose events keep their links as from one whose events do not."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.trace import Event as PlainEvent, Trace
from conftest import small_cell

MAIN, AUTOGRAD = 1, 2
EVAL = spans.EVALUATE + ": "
READERS = ("device_idle_pct.attack", "attack_mfu_pct", "kernels_per_attack",
           "chol_roofline_pct", "gmm_stats_roofline_pct",
           "loglike_roofline_pct")
TOOL = harness.load_module(harness.ROOT / "tools" / "layer_breakdown.py")


def _span(name, start, end):
    return spans.Event(name, start, end, thread=MAIN)


def _op(name, start, end, corr, thread=MAIN, seq=-1, fwd=0):
    return spans.Event(name, start, end, thread=thread, correlation=corr,
                       sequence=seq, fwd_thread=fwd)


def _call(start, corr, thread=MAIN):
    return spans.Event("cudaLaunchKernel", start, start + 2, thread=thread,
                       correlation=corr)


def _kernel(name, start, end, linked, corr):
    return spans.Event(name, start, end, linked=linked, correlation=corr)


def synthetic(node_seq=6):
    """One call: the frontend's and the TDNN's forward on the main thread,
    the loss in the iteration's own span, the TDNN's backward node (its
    sequence number ``node_seq``) and AccumulateGrad on the autograd
    thread, and a kernel after the call.  Op ids and CUPTI's ids overlap,
    as they do in a profile."""
    host = [
        _span("sg.pgd.call", 0, 1000), _span("sg.pgd.iter", 10, 900),
        _span("sg.frontend", 20, 200),
        _op("aten::mul", 30, 40, 11, seq=5), _call(32, 11),
        _span("sg.tdnn", 210, 400),
        _op("aten::matmul", 215, 245, 12, seq=6),
        _op("aten::mm", 220, 240, 13, seq=6), _call(225, 12),
        _op("aten::log_softmax", 410, 420, 14, seq=7), _call(412, 13),
        _op(EVAL + "MmBackward0", 500, 600, 15, thread=AUTOGRAD,
            seq=node_seq, fwd=MAIN),
        _op("aten::mm", 510, 520, 16, thread=AUTOGRAD), _call(512, 14,
                                                              AUTOGRAD),
        _op(EVAL + "torch::autograd::AccumulateGrad", 700, 720, 17,
            thread=AUTOGRAD),
        _op("aten::add_", 705, 710, 18, thread=AUTOGRAD), _call(706, 15,
                                                               AUTOGRAD),
        _op("aten::rand", 1050, 1060, 19), _call(1052, 16),
    ]
    kernels = [_kernel("k_frontend", 50, 150, 11, 11),
               _kernel("k_tdnn", 250, 350, 13, 12),
               _kernel("k_loss", 420, 450, 14, 13),
               _kernel("k_tdnn_bwd", 530, 600, 16, 14),
               _kernel("k_accumulate", 720, 730, 18, 15),
               _kernel("k_inputs", 1100, 1150, 19, 16)]
    return Trace(window=(0, 1200), kernels=kernels, host=host)


def _layers(tr):
    res = spans._Resolver(tr.host)
    return {k.name: res.layer(*res.launch(k)) for k in tr.kernels}


def _ns(layers, what):
    return {k: getattr(d, what) for k, d in layers.items()
            if getattr(d, what)}


def _plain(tr):
    """``tr`` with events that keep no links, as ``trace.stretch`` makes."""
    def strip(events):
        return [PlainEvent(e.name, e.start, e.end) for e in events]
    return Trace(window=tr.window, kernels=strip(tr.kernels),
                 copies=strip(tr.copies), host=strip(tr.host))


def _read(tr, calls, cell):
    ctx = SimpleNamespace(trace=tr, calls=calls, cell=cell)
    return {n: harness.part("metrics", n).read(ctx) for n in READERS}


def test_correlation_leads_a_kernel_to_its_layer():
    tr = synthetic()
    assert _layers(tr)["k_frontend"] == "frontend"
    assert _layers(tr)["k_tdnn"] == "tdnn"
    assert _layers(tr)["k_loss"] == "attack_loop"
    assert _layers(tr)["k_inputs"] is None
    # without the op's id, the runtime call's CUPTI id finds the launch
    for k in tr.kernels:
        k.linked = None
    assert _layers(tr)["k_tdnn"] == "tdnn"
    assert _layers(tr)["k_loss"] == "attack_loop"


@pytest.mark.parametrize("seq,layer", [(6, "tdnn"), (5, "frontend"),
                                       (7, "attack_loop")])
def test_sequence_number_leads_a_backward_kernel_to_its_layer(seq, layer):
    # the node on the autograd thread, outside every span, takes the layer
    # of the forward op with its (forward thread, sequence number)
    layers = _layers(synthetic(node_seq=seq))
    assert layers["k_tdnn_bwd"] == layer
    # a node with no forward op takes its calling thread's span
    assert layers["k_accumulate"] == "attack_loop"


def test_gap_goes_to_the_layer_of_the_kernel_that_ends_it():
    layers = spans.attribute(synthetic())
    # [0, 50) frontend; [150, 250) and [450, 530) tdnn; [350, 420) and
    # [600, 720) attack loop; [730, 1100) none; the tail [1150, 1200) none
    assert _ns(layers, "idle_ns") == {"frontend": 50, "tdnn": 180,
                                      "attack_loop": 190, None: 370}
    # what the card waited for: the launching op, or the backward node
    assert layers["tdnn"].waited_for == {"aten::mm": 100, "MmBackward0": 80}
    assert layers["attack_loop"].waited_for == {
        "aten::log_softmax": 70, "torch::autograd::AccumulateGrad": 120}


def test_layers_and_the_rest_make_the_stretch_device_time():
    tr = synthetic()
    tr.copies.append(_kernel("Memcpy HtoD", 1160, 1250, 19, 16))
    layers = spans.attribute(tr)
    total = sum(min(e.end, 1200) - e.start for e in tr.device_events())
    assert sum(d.device_ns for d in layers.values()) == total == 400
    assert _ns(layers, "device_ns") == {"frontend": 100, "tdnn": 170,
                                        "attack_loop": 40, None: 90}
    assert spans.coverage_pct(layers) == pytest.approx(100 * 310 / 400)
    assert _ns(layers, "kernels") == {"frontend": 1, "tdnn": 2,
                                      "attack_loop": 2, None: 1}
    # a layer with a span and no device time is there, at 0
    tr.host.append(_span("sg.plda", 402, 404))
    assert spans.attribute(tr)["plda"].device_ns == 0


def test_trace_without_spans_has_no_layer():
    tr = synthetic()
    tr.host = [e for e in tr.host if not e.name.startswith(spans.SPAN)]
    layers = spans.attribute(tr)
    assert list(layers) == [None] and spans.coverage_pct(layers) == 0


def _stand_in_kernels(tr):
    """On the CPU the host's leaf ops stand in for device events, named
    after the kernels the old readers select."""
    names = ("void (anonymous namespace)::sweep_kernel<float, false, "
             "false>(float const*)", "aug16_kernel", "loglike_gemm_kernel",
             "normalise_stats_kernel", "dl_direct_kernel",
             "daug_gemm_kernel", "chain_sum_kernel", "aug_split_kernel",
             "loglike_split_gemm_kernel", "elementwise_kernel")
    ops = sorted((e for e in tr.host if not e.name.startswith(spans.SPAN)),
                 key=lambda e: e.start)
    leaves = [e for e, nxt in zip(ops, ops[1:] + [None])
              if nxt is None or nxt.start >= e.end]
    tr.kernels = [spans.Event(names[i % len(names)], e.start, e.end,
                              linked=e.correlation)
                  for i, e in enumerate(leaves)]
    return tr


def _recorded_cell(cell, device):
    tr, calls = TOOL.record(cell, 2**31 + 91, device)
    return tr, calls, cell


def test_readers_read_the_same_without_the_links(cpu):
    # the GMM-kernel cell: every old reader selects some of its kernels
    cell = small_cell("iv_plda", "pgd10_b256_gmmk")
    cell.traffic["program"]["fast_path"]["enabled"] = True
    tr, calls, cell = _recorded_cell(cell, cpu)
    tr = _stand_in_kernels(tr)
    got = _read(tr, calls, cell)
    assert all(v is not None for v in got.values()), got
    assert _read(_plain(tr), calls, cell) == got
    # and the breakdown finds every layer of the cell
    out = TOOL.breakdown(tr, calls, 3)
    assert {k for k, v in out["layers"].items() if v["device_ms"] > 0} >= {
        "frontend", "gmm_stats", "ivector", "plda", "attack_loop"}
    # PGD-10 with no top-K context: the call's, the context's, the
    # iterations' and the final's, and 5 in each of 11 model evaluations
    assert out["spans_a_call"] == 13 + 11 * 5


@pytest.mark.cuda
def test_readers_read_the_same_without_the_links_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the GMM-kernel cell at its widths, one traced call of 16 waves
    cell = harness.load_cell("iv_pgd10_b256_gmmk")
    cell.traffic.update(batch=16, warmup_calls=1, trace_calls=1)
    tr, calls, cell = _recorded_cell(cell, torch.device("cuda", 0))
    got = _read(tr, calls, cell)
    assert all(v is not None for v in got.values()), got
    assert _read(_plain(tr), calls, cell) == got
    assert spans.coverage_pct(spans.attribute(tr)) >= 97
