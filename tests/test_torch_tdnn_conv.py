"""ops/tdnn_conv.py: the bf16 TDNN block's wrapper, its plain version and
the kernel's operands on the CPU; the kernel itself on the card.

The CPU cannot run csrc/tdnn_conv.cu, so ``emulate_fwd`` and
``emulate_bwd`` compute here what the kernel computes from the operands the
wrapper hands it: flat rows in the input's row stride, each tap a row
offset, the packed weights, the mask bits, rows past an operand read as
zeros, and junk rows (t >= T_out of an utterance) read but never stored.
The storage the kernel leaves unwritten is filled with NaN first, so a junk
row read as a value anywhere downstream shows.  With the launch replaced by
the emulation, the wrapper's whole kernel route (autograd, the layouts
handed from layer to layer, the stats pool's cotangent in its input's
layout) runs on the CPU against the plain version.  The emulation sums in
float64, so it is held to the plain version at tests/test_torch_tdnn.py's
bars (tests/tdnn_bars.py), as the card's kernel is.

The card tests (``-m cuda``) hold the kernel to ``fast_block_plain`` at
the same bars, at the headline shape and at ragged ones, the xv-PLDA
waveform gradient through it to the present im2col path on the card
(cosine 0.998, sign agreement 0.98, tests/test_torch_xv_plda.py's bars for
the bf16 blocks), and count its launches: 10 a PGD iteration.

This file runs on one CPU thread (``one_cpu_thread``) and imports no JAX.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from speakerguard_tpu_torch.models import tdnn as TT
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.ops import tdnn_conv as TC

from tdnn_bars import (assert_bf16_affine_close, assert_bf16_block_close,
                       assert_within_top_bf16_ulp)
from test_torch_build import c_declarations

CSRC = Path(TC.__file__).resolve().parent.parent / "csrc"
LAYERS = range(len(TT.TDNN_SPEC))
# (batch, frames, extra rows an utterance in the input's buffer)
SHAPES = {"b2_t60": (2, 60, 0), "b1_t45": (1, 45, 0),
          "b3_t37_strided": (3, 37, 5)}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One CPU thread, torch's and the BLAS libraries' alike, restored
    after the file (the six-worker test run); the card's machine has no
    threadpoolctl, and there torch's threads alone are limited."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    try:
        if threadpool_limits is None:
            yield
        else:
            with threadpool_limits(limits=1):
                yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tdnn():
    return TT.random_tdnn(np.random.default_rng(7), device="cpu")


def _flat(t, rows, ld, c):
    """The first ``rows`` flat rows (c columns) of a rows-layout view."""
    return t.as_strided((rows, c), (ld, 1))


def _poison(t, rows, ld):
    """NaN in every element the kernel may leave unwritten."""
    _flat(t, rows, ld, ld).fill_(float("nan"))


def _unpack(mbytes, c):
    shifts = torch.arange(8, dtype=torch.uint8)
    bits = (mbytes[..., None] >> shifts) & 1
    return bits.reshape(mbytes.shape[0], -1)[:, :c].bool()


def emulate_fwd(op):
    """What sg_tdnn_conv_fwd writes, from its arguments ``op``."""
    rows, cout, k, dil = op["rows"], op["cout"], op["k"], op["dil"]
    x = _flat(op["x"], op["x_rows"], op["x_ld"], op["cin"]).double()
    wf = op["wf"].double().view(cout, k, -1)[:, :, :op["cin"]]
    r = torch.arange(rows)
    acc = torch.zeros(rows, cout, dtype=torch.float64)
    for j in range(k):
        src = r + j * dil
        inside = ((src >= 0) & (src < op["x_rows"]))[:, None]
        a = torch.where(inside, x[src.clamp(0, op["x_rows"] - 1)], 0.0)
        acc += a @ wf[:, j].T
    bias, mean, s = (v[:cout] for v in op["vecs"])
    y = acc.float().bfloat16().float() + bias
    t = r % op["ts"]
    live = t < op["t_out"]
    m = live[:, None] & (y > 0)
    if op["affine"]:       # (mean, s) hold (c, a)
        o = (torch.where(m, y, 0.0) * s + mean).bfloat16()
    else:
        o = ((torch.where(m, y, 0.0) - mean) * s).bfloat16()
    _poison(op["out"], rows, op["out_ld"])
    _flat(op["out"], rows, op["out_ld"], cout)[live] = o[live]
    bits = torch.zeros(rows, op["mask_ld"] * 8, dtype=torch.uint8)
    bits[:, :cout] = m.to(torch.uint8)
    packed = (bits.view(rows, -1, 8) << torch.arange(8, dtype=torch.uint8))
    _flat(op["mask"], rows, op["mask_ld"], op["mask_ld"]).copy_(
        packed.sum(-1, dtype=torch.uint8))
    return 0


def emulate_bwd(op):
    """What sg_tdnn_conv_bwd writes, from its arguments ``op``."""
    rows, cin, cout, k, dil = (op["rows"], op["cin"], op["cout"], op["k"],
                               op["dil"])
    g_rows = op["g_rows"]
    g = _flat(op["g"], g_rows, op["g_ld"], cout).float()
    m = _unpack(_flat(op["mask"], g_rows, op["mask_ld"], op["mask_ld"]),
                cout)
    gy = torch.where(m, (g * op["s"][:cout]).bfloat16().float(), 0.0)
    gy = gy.double()
    wb = op["wb"].double().view(cin, k, -1)[:, :, :cout]
    r = torch.arange(rows)
    acc = torch.zeros(rows, cin, dtype=torch.float64)
    for j in range(k):
        src = r + j * dil - (k - 1) * dil
        inside = ((src >= 0) & (src < g_rows))[:, None]
        a = torch.where(inside, gy[src.clamp(0, g_rows - 1)], 0.0)
        acc += a @ wb[:, j].T
    live = r % op["ts"] < op["t_in"]
    _poison(op["gx"], rows, op["gx_ld"])
    _flat(op["gx"], rows, op["gx_ld"], cin)[live] = \
        acc.float().bfloat16()[live]
    return 0


# each entry point's argument names, the stream aside: the launch dict's
# keys (test_launch_dicts_name_the_arguments_in_order)
ARG_NAMES = {entry: [a.split()[-1].lstrip("*") for a in args[:-1]]
             for entry, args in c_declarations("tdnn_conv").items()}
EMULATE = {"sg_tdnn_conv_fwd": emulate_fwd, "sg_tdnn_conv_bwd": emulate_bwd}


def launch_dict(entry, args):
    """A launch's arguments as the launch dict they were passed from."""
    return dict(zip(ARG_NAMES[entry], args))


@pytest.fixture
def emulated(monkeypatch):
    """The wrapper's kernel route on CPU tensors, each launch emulated."""
    w = TC.tdnn_conv

    def launch(entry, device, *args):
        assert EMULATE[entry](launch_dict(entry, args)) == 0

    monkeypatch.setattr(w, "on_card", lambda t, what: True)
    monkeypatch.setattr(w, "lib", SimpleNamespace(launch=launch))
    w.reset_counts()
    yield w
    w.reset_counts()


def _block_case(tp, i, b, t, extra, device="cpu", seed=0):
    """Layer i's bf16 input (B, T, C_in), as a view with ``extra`` junk rows
    an utterance beyond T, an output cotangent and the block's
    arguments."""
    k, dil, cout = TT.TDNN_SPEC[i]
    cin = 30 if i == 0 else TT.TDNN_SPEC[i - 1][2]
    gen = torch.Generator(device=device).manual_seed(100 * i + seed)
    x = torch.randn(b, t + extra, cin, device=device, generator=gen)
    x = x.to(torch.bfloat16)[:, :t]
    g = torch.randn(b, t - (k - 1) * dil, cout, device=device,
                    generator=gen).to(torch.bfloat16)
    bn = tp.bn_tdnn[i]
    return x, g, (tp.conv_w[i], tp.conv_b[i], bn.mean, bn.var, dil)


def _block_and_grad(x, g, args):
    """The block's output, input cotangent (as the block's backward returns
    it, before autograd stores it) and ReLU mask as bool."""
    xk = x.detach().clone() if x.is_contiguous() else x.detach()
    xk.requires_grad_(True)
    raw = []
    xk.register_hook(raw.append)
    out = TT._BlockFastBf16.apply(xk, *args)
    mask = TC.mask_bool(out.grad_fn.saved_tensors[0], out.shape[-1])
    out.backward(g)
    return out.detach(), raw[0], mask


def _assert_close_to_plain(x, g, args, out, dx, mask):
    p_out, p_dx = TT.fast_block_plain(x, *args, g, True, mask)
    _, b, mean, var, _ = args
    assert_bf16_block_close(out.float().cpu().numpy(),
                            p_out.float().cpu().numpy(),
                            *(a.cpu().numpy() for a in (b, mean, var)))
    assert_within_top_bf16_ulp(dx.float().cpu().numpy(),
                               p_dx.float().cpu().numpy())


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("affine", [False, True])
def test_launch_plan_fills_the_operands_as_built(affine, layer, emulated,
                                                 monkeypatch):
    """A launch of a layout met before (its ``_Plan``) passes the C entry
    point what ``fwd_operands`` and ``bwd_operands`` build: the same
    entries in the same order, the same integers, tensors of the same
    shape, stride and contents; layer 1's 30 channels copied into rows of
    32 on both."""
    seen = []

    def launch(entry, device, *args):
        op = launch_dict(entry, args)
        seen.append((entry, op))
        assert EMULATE[entry](op) == 0

    monkeypatch.setattr(emulated, "lib", SimpleNamespace(launch=launch))
    tp = TT.random_tdnn(np.random.default_rng(3), device="cpu")
    x, g, args = _block_case(tp, layer, 2, 30, 3)
    if affine:
        gen = torch.Generator().manual_seed(4)
        c = args[0].shape[0]
        args = args + (torch.rand(c, generator=gen) + 0.5,
                       torch.rand(c, generator=gen) - 0.5)
        g = torch.randn(x.shape[0], x.shape[1], c, generator=gen).to(
            torch.bfloat16)
    emulated._plans.clear()
    for _ in range(2):
        out, saved = emulated.forward(x, *args)
        emulated.backward(g, *saved, args[4], *args[5:6])
    assert [e for e, _ in seen] == ["sg_tdnn_conv_fwd", "sg_tdnn_conv_bwd"] * 2
    for (_, first), (_, again) in zip(seen[:2], seen[2:]):
        assert list(first) == list(again)
        for k, a in first.items():
            b = again[k]
            if isinstance(a, torch.Tensor):
                assert (a.shape, a.stride()) == (b.shape, b.stride()), k
                if k not in ("out", "mask", "gx"):
                    assert torch.equal(a, b), k
            else:
                assert a == b, k
    assert torch.equal(seen[0][1]["out"], seen[2][1]["out"])
    assert torch.equal(seen[1][1]["gx"], seen[3][1]["gx"])


def _operands(entry):
    tp = TT.random_tdnn(np.random.default_rng(1), device="cpu")
    x, g, args = _block_case(tp, 1, 2, 30, 0)
    op = TC.fwd_operands(x, *args)
    if entry == "sg_tdnn_conv_fwd":
        return op
    return TC.bwd_operands(g, op["mask"], args[0], op["vecs"], args[-1])


@pytest.mark.parametrize("entry", ["sg_tdnn_conv_fwd", "sg_tdnn_conv_bwd"])
def test_launch_dicts_name_the_arguments_in_order(entry):
    """``fwd_operands`` and ``bwd_operands`` build their launch dicts in
    the entry point's argument order, under its argument names: the
    wrapper passes the dict's values in order."""
    assert list(_operands(entry)) == ARG_NAMES[entry]


def test_tiles_match_the_source():
    src = (CSRC / "tdnn_conv.cu").read_text()
    assert re.search(r"constexpr int TN = GN;", src)
    assert re.search(r"constexpr int TK = GK;", src)
    hdr = (CSRC / "wgmma_gemm.cuh").read_text()
    assert int(re.search(r"constexpr int GN = (\d+);", hdr).group(1)) == \
        TC.TILE_N
    assert int(re.search(r"constexpr int GK = (\d+);", hdr).group(1)) == \
        TC.TILE_K


REFUSALS = {
    "device": (lambda x, a: (x.to("meta"), tuple(
        t.to("meta") if isinstance(t, torch.Tensor) else t for t in a)),
        ValueError, "runs on cuda or cpu"),
    "dtype": (lambda x, a: (x.float(), a), TypeError, "bf16"),
    "channels": (lambda x, a: (x[..., :20], a), ValueError, "expected"),
    "too_short": (lambda x, a: (x[:, :4], a), ValueError, "shorter"),
    "bias_shape": (lambda x, a: (x, (a[0], a[1][:10]) + a[2:]), ValueError,
                   "b of shape"),
    "mixed_devices": (lambda x, a: (x, (a[0].to("meta"),) + a[1:]),
                      ValueError, "operands lie on"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses(tdnn, case):
    fn, exc, match = REFUSALS[case]
    x, _, args = _block_case(tdnn, 0, 2, 40, 0)
    x, args = fn(x, args)
    with pytest.raises(exc, match=match):
        TC.tdnn_conv.forward(x, *args)


def test_kernel_route_refuses_rows_it_cannot_read(tdnn, emulated):
    """Channels must be contiguous and utterances whole rows apart."""
    x, _, args = _block_case(tdnn, 1, 2, 40, 0)
    with pytest.raises(ValueError, match="channel-contiguous"):
        emulated.forward(x.transpose(0, 1).contiguous().transpose(0, 1),
                         *args)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="channel-contiguous"):
        emulated.forward(xt, *args)
    assert emulated.launches == 0


def test_rows_layout():
    base = torch.zeros(3, 50, 40)
    assert TC.rows_layout(base) == (50, 40)
    assert TC.rows_layout(base[:, :45]) == (50, 40)
    assert TC.rows_layout(base[:, :45, :30]) == (50, 40)
    assert TC.rows_layout(base[:1, :45]) == (50, 40)
    assert TC.rows_layout(base[:, ::2]) == (25, 80)
    for bad in (base.transpose(0, 1), base.transpose(1, 2), base.view(-1)):
        with pytest.raises(ValueError):
            TC.rows_layout(bad)
    view = TC.rows_tensor((3, 7, 5), 9, 8, torch.bfloat16, "cpu")
    assert view.stride() == (72, 8, 1)
    assert view.untyped_storage().nbytes() == (2 * 9 + 7) * 8 * 2
    assert TC.rows_layout(view) == (9, 8)


@pytest.mark.parametrize("i", LAYERS)
def test_plain_version_is_the_im2col_block(tdnn, i):
    """block_fwd_plain / block_bwd_plain compute the im2col block's steps
    bit for bit: the conv's f32 sum rounded once to bf16, the bias, ReLU and
    BN in float32, the transposed conv of bf16(where(mask, g s, 0))."""
    x, g, (w, b, mean, var, dil) = _block_case(tdnn, i, 2, 50, 0)
    w16 = w.to(torch.bfloat16)
    y = torch.add(TT._conv1d(x, w16, None, dil), b)
    mask = y > 0
    out = TT._bn(torch.where(mask, y, 0.0), TT.BNStats(mean, var))
    gy = torch.where(mask, g * torch.rsqrt(var + TT.BN_EPS), 0.0)
    gx = TT._conv1d_input_grad(gy.to(torch.bfloat16), w16, dil)
    p_out, p_mask, p_w16 = TC.block_fwd_plain(x, w, b, mean, var, dil)
    assert torch.equal(p_out, out.to(torch.bfloat16))
    assert torch.equal(p_mask, mask) and torch.equal(p_w16, w16)
    assert torch.equal(TC.block_bwd_plain(g, mask, w16, var, dil), gx)


def test_cpu_tensors_take_the_plain_version(tdnn):
    w = TC.tdnn_conv
    w.reset_counts()
    x, g, args = _block_case(tdnn, 2, 2, 50, 0)
    out, dx, _ = _block_and_grad(x, g, args)
    assert (w.launches, w.plain_calls) == (0, 2)
    xk = x.clone().requires_grad_(True)
    saved = TT._BlockFastBf16.apply(xk, *args).grad_fn.saved_tensors
    assert saved[0].dtype == torch.bool and saved[0].shape == out.shape
    assert out.is_contiguous() and dx.shape == x.shape
    w.reset_counts()


def test_layer1_is_padded_to_32_channels(tdnn, emulated):
    """Layer 1's 30 channels are a 60-byte row that TMA cannot address: the
    wrapper copies them into rows of 32, the packed weights hold zeros past
    channel 30, and the result is the unpadded one; the backward stores
    the 30 real columns."""
    x, g, args = _block_case(tdnn, 0, 2, 60, 0)
    op = TC.fwd_operands(x, *args)
    assert (op["cin"], op["x_ld"]) == (30, 32)
    assert torch.equal(op["x"][..., :30], x)
    wf = op["wf"].view(512, 5, 64)
    assert torch.equal(wf[:, :, :30],
                       args[0].to(torch.bfloat16).permute(0, 2, 1))
    assert not wf[:, :, 30:].any()
    assert op["wf"].shape == (512, 5 * 64)
    wb = TC.weight_packs(args[0])[1]
    assert wb.shape == (30, 5 * 512)
    out, dx, mask = _block_and_grad(x, g, args)
    assert dx.shape == (2, 60, 30) and dx.stride() == (60 * 32, 32, 1)
    assert emulated.launches == 2
    _assert_close_to_plain(x, g, args, out, dx, mask)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("i", LAYERS)
def test_kernel_route_matches_plain(tdnn, emulated, i, shape):
    """Each layer through the wrapper's kernel route (launches emulated):
    the output is a view in the input's row stride, the mask bits are the
    ReLU mask (0 past the channels), the input cotangent comes back in the
    input's row stride, and both are within the bars of the plain
    version."""
    b, t, extra = SHAPES[shape]
    x, g, args = _block_case(tdnn, i, b, t, extra)
    out, dx, mask = _block_and_grad(x, g, args)
    k, dil, cout = TT.TDNN_SPEC[i]
    ts = t + extra
    assert out.shape == (b, t - (k - 1) * dil, cout)
    assert TC.rows_layout(out) == (ts, -(-cout // 8) * 8)
    assert TC.rows_layout(dx)[0] == ts and dx.shape == x.shape
    assert emulated.launches == 2
    assert torch.isfinite(out.float()).all()
    assert torch.isfinite(dx.float()).all()
    _assert_close_to_plain(x, g, args, out, dx, mask)


def test_weight_packs_are_kept_until_the_weight_changes(tdnn):
    w = tdnn.conv_w[2].clone()
    wf, wb = TC.weight_packs(w)
    assert TC.weight_packs(w)[0] is wf
    assert torch.equal(wb.view(512, 7, 512)[:, 0],
                       w[:, :, 6].to(torch.bfloat16).T)
    w.mul_(2.0)
    wf2, _ = TC.weight_packs(w)
    assert wf2 is not wf
    assert torch.equal(wf2.view(512, 7, 512)[:, 3],
                       w[:, :, 3].to(torch.bfloat16))


def test_embedding_through_the_kernel_route(tdnn, emulated):
    """The five blocks and the stats pool chained on the kernel route: each
    layer reads its input in place in the features' row stride (junk rows
    NaN), the pool's cotangent goes back in the last block's layout (no
    copy), and the x-vector and its feature gradient match the plain
    route's (the embedding at 2e-3 of its largest entry, as
    tests/test_torch_tdnn.py holds it to JAX's; the gradient at cosine
    0.998 and sign agreement 0.98)."""
    feats = torch.randn(3, 70, 30, generator=torch.Generator().manual_seed(5))
    copies = []
    orig = TC._kernel_rows

    def kernel_rows(t, ts):
        got = orig(t, ts)
        copies.append(got is not t)
        return got

    def run():
        f = feats.clone().requires_grad_(True)
        emb = TT.tdnn_embedding(tdnn, f, fast=FastPath())
        emb.square().sum().backward()
        return emb.detach(), f.grad

    emb, grad = run()
    assert emulated.launches == 10
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TC, "_kernel_rows", kernel_rows)
        emulated.reset_counts()
        run()
    # layer 1's 30 channels are copied into rows of 32; nothing else
    assert copies == [True] + [False] * 9
    mp_route = pytest.MonkeyPatch()
    mp_route.setattr(emulated, "route", lambda t: False)
    try:
        want, want_grad = run()
    finally:
        mp_route.undo()
    assert torch.isfinite(emb).all() and torch.isfinite(grad).all()
    assert (emb - want).abs().max() <= 2e-3 * want.abs().max()
    g, gw = grad.flatten().double(), want_grad.flatten().double()
    assert torch.dot(g, gw) / (g.norm() * gw.norm()) >= 0.998
    assert (torch.sign(g) == torch.sign(gw)).double().mean() >= 0.98


def test_stats_pool_cotangent_keeps_the_input_layout():
    x = TC.rows_tensor((2, 6, 12), 9, 16, torch.bfloat16, "cpu")
    x.copy_(torch.randn(2, 6, 12))
    xk = x.detach().requires_grad_(True)
    raw = []
    xk.register_hook(raw.append)
    TT._StatsPoolFastBf16.apply(xk).sum().backward()
    assert raw[0].stride() == x.stride()
    want = torch.randn(2, 6, 12).to(torch.bfloat16).requires_grad_(True)
    with torch.no_grad():
        want.copy_(x)
    TT._StatsPoolFastBf16.apply(want).sum().backward()
    assert torch.equal(xk.grad, want.grad)


def test_mask_bool_reads_both_forms():
    m = torch.rand(2, 5, 21) > 0.5
    assert TC.mask_bool(m, 21) is m
    bits = torch.zeros(2, 5, 8 * 8, dtype=torch.uint8)
    bits[..., :21] = m.to(torch.uint8)
    packed = (bits.view(2, 5, 8, 8)
              << torch.arange(8, dtype=torch.uint8)).sum(-1,
                                                         dtype=torch.uint8)
    assert torch.equal(TC.mask_bool(packed, 21), m)


# ---------------------------------------------------------------------------
# ECAPA-TDNN's forms: "same" convolutions with reflect padding, an affine
# BN, 128-wide outputs
# ---------------------------------------------------------------------------

# (C_in, C_out, k, dilation): h0's taps, the Res2 branches at the smallest
# and largest dilation, a 1x1 block
FORMS = {"h0_k5": (80, 64, 5, 1), "res2_d2": (128, 128, 3, 2),
         "res2_d4": (128, 128, 3, 4), "pointwise": (96, 160, 1, 1)}
AFFINE_SHAPES = {"b2_t40": (2, 40, 0), "b3_t23_strided": (3, 23, 5)}


def _affine_case(form, b, t, extra, device="cpu", seed=0):
    """A block of ``form`` with random weights and affine BN: its bf16
    input (B, T, C_in) as a view with ``extra`` rows an utterance beyond T,
    an output cotangent (B, T, C_out) and the block's arguments (w, b,
    mean, var, dilation, gamma, beta)."""
    cin, cout, k, dil = form
    gen = torch.Generator(device=device).manual_seed(1000 + seed)

    def uni(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)
    bound = 1.0 / np.sqrt(cin * k)
    w = uni((cout, cin, k), -bound, bound)
    bias = uni((cout,), -bound, bound)
    mean, var = uni((cout,), 0.0, 0.1), uni((cout,), 0.5, 1.5)
    gamma, beta = uni((cout,), 0.5, 1.5), uni((cout,), -0.1, 0.1)
    x = torch.randn(b, t + extra, cin, device=device, generator=gen)
    x = x.to(torch.bfloat16)[:, :t]
    g = torch.randn(b, t, cout, device=device,
                    generator=gen).to(torch.bfloat16)
    return x, g, (w, bias, mean, var, dil, gamma, beta)


def _assert_affine_close_to_plain(x, g, args, out, dx, mask):
    """The bf16 output within the affine bar of the float64 block, the
    input cotangent within two bf16 ulps of its largest entry: one for
    the GEMM's rounding, one for the fold, whose edge rows add two bf16
    cotangents and round again."""
    w, b, mean, var, dil, gamma, beta = args
    p_out, p_dx = TT.fast_block_plain(x, w, b, mean, var, dil, g, True,
                                      mask, gamma, beta)
    a, c = TC.affine_bn(mean, var, gamma, beta)
    assert_bf16_affine_close(out.float().cpu().numpy(),
                             p_out.float().cpu().numpy(),
                             *(v.cpu().numpy() for v in (b, a, c)))
    assert_within_top_bf16_ulp(dx.float().cpu().numpy(),
                               p_dx.float().cpu().numpy(), ulps=2)


def test_reflect_rows_and_fold_are_torch_reflect_padding():
    """reflect_rows is F.pad's reflect mode along time, in rows of 8; its
    fold is that padding's cotangent (autograd of F.pad)."""
    x = torch.randn(2, 11, 5)
    want = torch.nn.functional.pad(x.transpose(1, 2), (3, 3),
                                   mode="reflect").transpose(1, 2)
    got = TC.reflect_rows(x, 3)
    assert torch.equal(got, want) and got.stride(1) == 8
    full = torch.randn(2, 17, 5)
    xr = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.nn.functional.pad(
        xr.transpose(1, 2), (3, 3), mode="reflect").transpose(1, 2), xr,
        full)
    assert torch.allclose(TC.fold_reflected(full.clone(), 3), g, atol=1e-6)


@pytest.mark.parametrize("shape", sorted(AFFINE_SHAPES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_same_affine_block_matches_float64(form, shape):
    """The plain block (CPU tensors) in ECAPA's forms against float64
    F.conv1d on F.pad's reflect padding (``fast_block_plain``), forward and
    input gradient; the 128-wide outputs, the 1x1 block and dilated taps
    among them."""
    w = TC.tdnn_conv
    w.reset_counts()
    x, g, args = _affine_case(FORMS[form], *AFFINE_SHAPES[shape])
    out, dx, mask = _block_and_grad(x, g, args)
    assert (w.launches, w.plain_calls) == (0, 2)
    assert out.shape == g.shape and dx.shape == x.shape
    _assert_affine_close_to_plain(x, g, args, out, dx, mask)
    w.reset_counts()


@pytest.mark.parametrize("shape", sorted(AFFINE_SHAPES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_kernel_route_same_affine_matches_plain(emulated, form, shape):
    """ECAPA's forms through the kernel route (launches emulated): a
    padded block's input gathered into T + 2 P rows an utterance and run
    as a valid convolution (its output and mask the first T rows an
    utterance of that stride), its cotangent folded back; a 1x1 block keeps
    its input's row stride.  Both within the bars of the float64
    block."""
    cin, cout, k, dil = FORMS[form]
    b, t, extra = AFFINE_SHAPES[shape]
    x, g, args = _affine_case(FORMS[form], b, t, extra)
    out, dx, mask = _block_and_grad(x, g, args)
    pad = (k - 1) * dil // 2
    ts = t + 2 * pad if pad else t + extra
    assert out.shape == (b, t, cout) and dx.shape == x.shape
    assert TC.rows_layout(out) == (ts, -(-cout // 8) * 8)
    assert emulated.launches == 2
    assert torch.isfinite(out.float()).all()
    assert torch.isfinite(dx.float()).all()
    _assert_affine_close_to_plain(x, g, args, out, dx, mask)


SAME_REFUSALS = {
    "even_span": (lambda a: a[:4] + (1,) + a[5:], (64, 64, 2, 1),
                  "odd span"),
    "too_short": (lambda a: a, (16, 16, 3, 4), "shorter"),
    "gamma_only": (lambda a: a[:6] + (None,) + a[7:], (16, 16, 3, 1),
                   "both gamma and beta"),
}


@pytest.mark.parametrize("case", sorted(SAME_REFUSALS))
def test_same_affine_refusals(case):
    fn, form, match = SAME_REFUSALS[case]
    x, _, args = _affine_case(form, 2, 9, 0)
    with pytest.raises(ValueError, match=match):
        TC.tdnn_conv.forward(x, *fn(args))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_SHAPES = {"b8_t300": (8, 300, 0), "b1_t300": (1, 300, 0),
               "b3_t77": (3, 77, 0), "b5_t131_strided": (5, 131, 9)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("i", LAYERS)
def test_kernel_matches_plain_on_card(i, shape):
    """The kernel's block against fast_block_plain on the card, at the bars
    of tests/test_torch_tdnn.py's test_fast_block_on_card_matches_plain:
    the headline length, batch 1, B T not a multiple of the 128-row tile
    (T_out not one either), and an input held in a longer row stride."""
    _need_card()
    tp = TT.random_tdnn(np.random.default_rng(0), device="cuda")
    b, t, extra = CARD_SHAPES[shape]
    x, g, args = _block_case(tp, i, b, t, extra, device="cuda")
    w = TC.tdnn_conv
    w.reset_counts()
    out, dx, mask = _block_and_grad(x, g, args)
    torch.cuda.synchronize()
    assert (w.launches, w.plain_calls) == (2, 0)
    _assert_close_to_plain(x, g, args, out, dx, mask)


def _xv_model(device):
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    rng = np.random.default_rng(1234)
    model = XvPlda(random_xv_plda_params(rng, device=device),
                   fast=FastPath())
    model.set_enrollment([str(i) for i in range(5)], torch.tensor(
        rng.standard_normal((5, 150)).astype(np.float32), device=device))
    return model


@pytest.mark.cuda
def test_xv_gradient_through_the_kernel_matches_the_im2col_path(
        monkeypatch):
    """The xv-PLDA waveform gradient of FastPath() on the card through the
    kernel against the same model with the blocks' plain im2col version
    (the path before the kernel), at the bf16 blocks' bars."""
    _need_card()
    model = _xv_model("cuda")
    wavs = torch.tensor(np.random.default_rng(3).uniform(
        -0.3, 0.3, (4, 16000)).astype(np.float32), device="cuda")

    def grad():
        x = wavs.clone().requires_grad_(True)
        model.score(x, fast=True)[:, 0].sum().backward()
        return x.grad.flatten().double()

    w = TC.tdnn_conv
    w.reset_counts()
    g = grad()
    assert (w.launches, w.plain_calls) == (10, 0)
    monkeypatch.setattr(w, "route", lambda t: False)
    gw = grad()
    assert torch.dot(g, gw) / (g.norm() * gw.norm()) >= 0.998
    assert (torch.sign(g) == torch.sign(gw)).double().mean() >= 0.98


@pytest.mark.cuda
def test_pgd10_launches_the_kernel_ten_times_an_iteration():
    """PGD-10 on xv-PLDA, FastPath(): each iteration's forward and input
    gradient launch the kernel once a block (5 + 5); the final evaluation
    is the exact path."""
    _need_card()
    from speakerguard_tpu_torch.attacks import PGD
    model = _xv_model("cuda")
    x = torch.tensor(np.random.default_rng(4).uniform(
        -0.3, 0.3, (4, 16000)).astype(np.float32), device="cuda")
    w = TC.tdnn_conv
    w.reset_counts()
    PGD(model, task="CSI", epsilon=0.002, step_size=0.0004, max_iter=10,
        loss="Entropy").attack(x, torch.zeros(4, dtype=torch.long,
                                              device="cuda"), rng=0)
    torch.cuda.synchronize()
    assert (w.launches, w.plain_calls) == (100, 0)


# ECAPA-TDNN's launches at its published widths (C = 1024, Res2 128, MFA
# 1536, attention 128): h0, a block's 1x1 layers, the Res2 branches at
# each dilation, MFA and the pooling's first layer
CARD_FORMS = {"h0": (80, 1024, 5, 1), "tdnn1": (1024, 1024, 1, 1),
              "res2_d2": (128, 128, 3, 2), "res2_d3": (128, 128, 3, 3),
              "res2_d4": (128, 128, 3, 4), "mfa": (3072, 1536, 1, 1),
              "asp": (4608, 128, 1, 1)}
CARD_AFFINE_SHAPES = {"b8_t300": (8, 300, 0), "b3_t77": (3, 77, 0),
                      "b5_t131_strided": (5, 131, 9)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_AFFINE_SHAPES))
@pytest.mark.parametrize("form", sorted(CARD_FORMS))
def test_ecapa_kernel_matches_plain_on_card(form, shape):
    """The kernel in ECAPA's forms (reflect padding, affine BN, 128-wide
    tiles) against the float64 block on the card, at the bars of the CPU
    case: the headline length, B T not a multiple of the 128-row tile, and
    an input held in a longer row stride."""
    _need_card()
    x, g, args = _affine_case(CARD_FORMS[form], *CARD_AFFINE_SHAPES[shape],
                              device="cuda")
    w = TC.tdnn_conv
    w.reset_counts()
    out, dx, mask = _block_and_grad(x, g, args)
    torch.cuda.synchronize()
    assert (w.launches, w.plain_calls) == (2, 0)
    _assert_affine_close_to_plain(x, g, args, out, dx, mask)
