"""The port's TDNN (models/tdnn.py) against the JAX package's, on the same
weights.

Weights are drawn once with numpy through the JAX package's
random_xv_plda_params and carried across with convert.from_jax_params; the
TDNN's widths are fixed by TDNN_SPEC, so the size is cut in batch and
length only.  Each fast block and stats pool is held to JAX's custom-VJP
function through ``jax.vjp`` on the same input and cotangent.  Bars:

- float32 quantities (the exact path, the f32 fast blocks on the CPU, where
  the fast dtype is float32 on both sides): rtol 1e-5 with an absolute
  floor of 1e-5 of the largest entry (five convolutions' sums in another
  order);
- bf16 outputs, element by element: within one bf16 ulp of the output
  plus one bf16 ulp of the conv output times the BN scale, plus the
  float32 floor of 1e-5 of the largest entry.  The block rounds twice, as
  JAX's does: the conv's float32 sum to bf16 before the bias, then the
  BN's result.  Both sides round float32 sums of another order, and a sum
  can cross a rounding boundary; where the conv output's rounding flips,
  the output moves by one ulp of the conv output times the BN scale, which
  is more than one ulp of an output that the bias brought near zero
  (measured: 1 of 53k entries against JAX, two ulps of the output).  The
  float32 sums themselves differ by an absolute round-off (~1e-6 at these
  widths, whatever the entry's size), which the floor covers;
- bf16 cotangents: within one bf16 ulp of the largest entry, for the same
  reason.

The blocks' plain version (``fast_block_plain``, its backward on the
block's own ReLU mask) is held to the same bars.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.models import tdnn as JT
from speakerguard_tpu.models.xv_plda import random_xv_plda_params

from speakerguard_tpu_torch.convert import _tdnn as convert_tdnn
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models import tdnn as TT
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.models.xv_plda import (
    random_xv_plda_params as port_random_xv_plda_params)

LAYERS = range(len(TT.TDNN_SPEC))


@pytest.fixture(scope="module")
def tdnn():
    params = random_xv_plda_params(np.random.default_rng(1234))
    port = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    return params.tdnn, port.tdnn


def _feats(seed, b=3, t=80):
    return np.random.default_rng(seed).standard_normal((b, t, 30)).astype(
        np.float32)


def _f32_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def bf16_ulp(a):
    """The spacing of bf16 numbers at |a| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2 ** -126))
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_bf16_block_close(got, want, b, mean, var):
    """The bf16 output bar of this file's header, for a block whose bias,
    BN mean and BN variance are ``b``, ``mean``, ``var`` (channels last):
    the conv output is at most (|out| + one ulp) / s + |b - mean| in
    magnitude, the ulp for the output's own rounding."""
    b, mean, var = (np.asarray(a, np.float32) for a in (b, mean, var))
    s = 1.0 / np.sqrt(var + TT.BN_EPS)
    mag = np.maximum(np.abs(got), np.abs(want))
    conv_mag = (mag + bf16_ulp(mag)) / s + np.abs(b - mean)
    tol = (bf16_ulp(mag) + s * bf16_ulp(conv_mag)
           + 1e-5 * np.abs(want).max())
    diff = np.abs(got - want)
    assert np.all(diff <= tol), f"max excess {(diff - tol).max()}"


def assert_within_top_bf16_ulp(got, want):
    """Every entry within one bf16 ulp of the largest entry of ``want``."""
    diff = np.abs(got - want).max()
    assert diff <= bf16_ulp(np.abs(want).max()), f"max diff {diff}"


def _layer_input(i, seed=0, b=2, t=60):
    cin = 30 if i == 0 else TT.TDNN_SPEC[i - 1][2]
    return np.random.default_rng(seed + i).standard_normal(
        (b, t, cin)).astype(np.float32)


def test_random_params_are_jax_draws_transposed(tdnn):
    """random_xv_plda_params draws the JAX package's numbers in its order:
    the port's own draw from the seed equals the converted JAX draw."""
    own = port_random_xv_plda_params(np.random.default_rng(1234),
                                     device="cpu").tdnn
    _, port = tdnn
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(port)):
        assert torch.equal(a, b)
    assert port.conv_w[2].shape == (512, 512, 7)
    assert port.fc1_w.shape == (512, 3000)


def _run_block(jax_block, port_block, jp, tp, i, bf16):
    """One block forward and backward in both packages on the same input
    and cotangent; returns (jax out, port out, jax dx, port dx), float32
    arrays in (B, T, C), and the port's weight with its .grad."""
    dil = TT.TDNN_SPEC[i][1]
    dt = jnp.bfloat16 if bf16 else jnp.float32
    x = jnp.asarray(_layer_input(i), dt)
    args = (jp.conv_w[i], jp.conv_b[i], jp.bn_tdnn[i].mean,
            jp.bn_tdnn[i].var)
    out, vjp = jax.vjp(lambda xx: jax_block(dil)(xx, *args), x)
    g = jnp.asarray(np.random.default_rng(100 + i).standard_normal(
        out.shape), dt)
    (dx,) = vjp(g)

    def to_port(a):
        t = torch.tensor(np.asarray(a.astype(jnp.float32)))
        return t.to(torch.bfloat16 if bf16 else torch.float32)

    xt = to_port(x).requires_grad_(True)
    w = tp.conv_w[i].clone().requires_grad_(True)
    o = port_block.apply(xt, w, tp.conv_b[i], tp.bn_tdnn[i].mean,
                         tp.bn_tdnn[i].var, dil)
    o.backward(to_port(g))
    assert o.dtype == xt.grad.dtype == xt.dtype

    def back(a):
        return a.detach().float().numpy()

    return (np.asarray(out.astype(jnp.float32)), back(o),
            np.asarray(dx.astype(jnp.float32)), back(xt.grad), w)


@pytest.mark.parametrize("i", LAYERS)
def test_block_fast_matches_jax_vjp(tdnn, i):
    """_BlockFast against _block_fast: the exact f32 forward and, on the
    CPU where the fast dtype is float32, the f32 transposed-conv backward;
    no cotangent for the weights."""
    jp, tp = tdnn
    out, got, dx, gdx, w = _run_block(JT._block_fast, TT._BlockFast, jp, tp,
                                      i, bf16=False)
    _f32_close(got, out)
    _f32_close(gdx, dx)
    assert w.grad is None


@pytest.mark.parametrize("i", LAYERS)
def test_block_fast_bf16_matches_jax_vjp(tdnn, i):
    """_BlockFastBf16 against _block_fast_bf16, which runs in bf16 on every
    backend: the bf16 bars of this file's header; no cotangent for the
    weights."""
    jp, tp = tdnn
    out, got, dx, gdx, w = _run_block(JT._block_fast_bf16, TT._BlockFastBf16,
                                      jp, tp, i, bf16=True)
    assert_bf16_block_close(got, out, *map(np.asarray, (
        jp.conv_b[i], jp.bn_tdnn[i].mean, jp.bn_tdnn[i].var)))
    assert_within_top_bf16_ulp(gdx, dx)
    assert w.grad is None


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stats_pool_fast_matches_jax_vjp(bf16):
    """_StatsPoolFast / _StatsPoolFastBf16 against _stats_pool_fast /
    _stats_pool_fast_bf16: f32 (B, 3000) stats at f32 round-off; the
    cotangent from the bf16 residual at f32 round-off (f32 input) or
    within one bf16 ulp of its largest entry (bf16 input, bf16
    cotangent)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 1500)).astype(np.float32)
    fn = JT._stats_pool_fast_bf16 if bf16 else JT._stats_pool_fast
    port = TT._StatsPoolFastBf16 if bf16 else TT._StatsPoolFast
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    out, vjp = jax.vjp(fn, xj)
    g = rng.standard_normal(out.shape).astype(np.float32)
    (dx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32)))
    xt = xt.to(torch.bfloat16 if bf16 else torch.float32).requires_grad_()
    got = port.apply(xt)
    got.backward(torch.tensor(g))
    assert got.dtype == torch.float32 and xt.grad.dtype == xt.dtype
    _f32_close(got.detach().numpy(), np.asarray(out))
    dx = np.asarray(dx.astype(jnp.float32))
    gdx = xt.grad.float().numpy()
    if bf16:
        assert_within_top_bf16_ulp(gdx, dx)
    else:
        _f32_close(gdx, dx)


def test_stats_pool_backward_keeps_the_std_floor():
    """A constant channel has std 0: the std term's denominator is floored
    at 1e-12, as in JAX, so its cotangent is finite."""
    x = torch.ones(1, 10, 3, requires_grad=True)
    TT._StatsPoolFast.apply(x).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), 0.1, rtol=1e-6)


def test_tdnn_embedding_exact_matches_jax(tdnn):
    jp, tp = tdnn
    feats = _feats(11)
    want = np.asarray(JT.tdnn_embedding(jp, jnp.asarray(feats)))
    got = TT.tdnn_embedding(tp, torch.tensor(feats)).numpy()
    assert got.shape == want.shape == (3, 512)
    _f32_close(got, want)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tdnn_embedding_fast_matches_jax(tdnn, monkeypatch, bf16):
    """tdnn_embedding(fast=FastPath(...)) against JAX's fast=True under the
    matching SG_TDNN_FAST / SG_TDNN_BF16_ACT: the f32 blocks give the exact
    forward; the bf16 blocks round the same sums to bf16 in five layers,
    where one sum-order rounding flip moves a few embeddings by an ulp of
    their layer, so the embedding is held at 2e-3 of its largest entry (as
    the iv fast path's scores are)."""
    jp, tp = tdnn
    monkeypatch.setenv("SG_TDNN_FAST", "1")
    monkeypatch.setenv("SG_TDNN_BF16_ACT", "1" if bf16 else "0")
    feats = _feats(13)
    want = np.asarray(JT.tdnn_embedding(jp, jnp.asarray(feats), fast=True))
    got = TT.tdnn_embedding(tp, torch.tensor(feats),
                            fast=FastPath(tdnn_bf16_act=bf16)).numpy()
    if bf16:
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    else:
        _f32_close(got, want)
        np.testing.assert_array_equal(
            got, TT.tdnn_embedding(tp, torch.tensor(feats)).numpy())


def test_fast_false_and_tdnn_fast_off_run_the_exact_path(tdnn):
    _, tp = tdnn
    x = torch.tensor(_feats(17), requires_grad=True)
    emb = TT.tdnn_embedding(tp, x, fast=FastPath(tdnn_fast=False))
    assert emb.grad_fn.__class__.__name__ == "AddmmBackward0"
    exact = TT.tdnn_embedding(tp, x)
    assert torch.equal(emb, exact)


def test_tdnn_forward_matches_jax(tdnn):
    jp, tp = tdnn
    feats = _feats(19)
    want = np.asarray(JT.tdnn_forward(jp, jnp.asarray(feats)))
    got = TT.tdnn_forward(tp, torch.tensor(feats)).numpy()
    assert got.shape == want.shape == (3, 251)
    _f32_close(got, want)


def _reference_state(rng, num_spks=7):
    """A random state dict with the reference checkpoint's names and
    PyTorch layouts (Conv1d (out, in, k), Linear (out, in))."""
    state, cin = {}, 30
    for i, (k, _, cout) in enumerate(TT.TDNN_SPEC, start=1):
        state[f"tdnn{i}.weight"] = rng.standard_normal((cout, cin, k)) * 0.1
        state[f"tdnn{i}.bias"] = rng.standard_normal(cout) * 0.1
        state[f"bn_tdnn{i}.running_mean"] = rng.standard_normal(cout) * 0.1
        state[f"bn_tdnn{i}.running_var"] = rng.uniform(0.5, 2.0, cout)
        cin = cout
    for name, (o, i) in (("fc1", (512, 3000)), ("fc2", (512, 512)),
                         ("fc3", (num_spks, 512))):
        state[f"{name}.weight"] = rng.standard_normal((o, i)) * 0.05
        state[f"{name}.bias"] = rng.standard_normal(o) * 0.1
    for name in ("bn_fc1", "bn_fc2"):
        state[f"{name}.running_mean"] = rng.standard_normal(512) * 0.1
        state[f"{name}.running_var"] = rng.uniform(0.5, 2.0, 512)
    return {k: v.astype(np.float32) for k, v in state.items()}


def test_load_tdnn_from_torch_state_matches_jax():
    """The port keeps the checkpoint's layout: its loader on a state dict
    of tensors gives the JAX loader's weights, transposed as convert.py
    carries them, and the same logits."""
    state = _reference_state(np.random.default_rng(23))
    jp = JT.load_tdnn_from_torch_state(state)
    tp = TT.load_tdnn_from_torch_state(
        {k: torch.tensor(v) for k, v in state.items()}, device="cpu")
    carried = convert_tdnn(jax.tree.map(np.asarray, jp), "cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(carried)):
        assert torch.equal(a, b)
    assert torch.equal(tp.conv_w[0], torch.tensor(state["tdnn1.weight"]))
    feats = _feats(29)
    np.testing.assert_allclose(
        TT.tdnn_forward(tp, torch.tensor(feats)).numpy(),
        np.asarray(JT.tdnn_forward(jp, jnp.asarray(feats))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("i", LAYERS)
def test_fast_block_matches_its_plain_version(tdnn, i, bf16):
    """Each fast block against fast_block_plain, the float32 version that
    rounds where the block rounds (what the card checks it against), its
    backward on the block's own ReLU mask: the GEMMs and the convolutions
    sum in another order, and the bf16 block's round the same float32 sums
    once."""
    _, tp = tdnn
    x, g, args = _block_case(tp, i, bf16, b=2, t=300, device="cpu")
    out, dx, mask = _block_and_grad(x, g, args, bf16)
    p_out, p_dx = TT.fast_block_plain(x, *args, g, bf16, mask)
    _assert_block_close(out, dx, p_out, p_dx, args, bf16)


def _block_case(tp, i, bf16, b, t, device):
    """Layer i's input (B, T, C), an output cotangent and the block's
    arguments, from a fixed seed on ``device``."""
    k, dil, cout = TT.TDNN_SPEC[i]
    cin = 30 if i == 0 else TT.TDNN_SPEC[i - 1][2]
    gen = torch.Generator(device=device).manual_seed(i)
    x = torch.randn(b, t, cin, device=device, generator=gen)
    g = torch.randn(b, t - (k - 1) * dil, cout, device=device, generator=gen)
    if bf16:
        x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
    bn = tp.bn_tdnn[i]
    return x, g, (tp.conv_w[i], tp.conv_b[i], bn.mean, bn.var, dil)


def _block_and_grad(x, g, args, bf16):
    """The block's output, input cotangent and saved ReLU mask."""
    xk = x.clone().requires_grad_(True)
    out = (TT._BlockFastBf16 if bf16 else TT._BlockFast).apply(xk, *args)
    mask = out.grad_fn.saved_tensors[0]
    out.backward(g)
    return out.detach(), xk.grad, mask


def _assert_block_close(out, dx, p_out, p_dx, args, bf16):
    """The bars of this file's header; ``args`` are the block's."""
    out, dx, p_out, p_dx = (a.float().cpu().numpy()
                            for a in (out, dx, p_out, p_dx))
    if bf16:
        _, b, mean, var, _ = args
        assert_bf16_block_close(out, p_out, *(a.cpu().numpy()
                                              for a in (b, mean, var)))
        assert_within_top_bf16_ulp(dx, p_dx)
    else:
        _f32_close(out, p_out)
        _f32_close(dx, p_dx)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("i", LAYERS)
def test_fast_block_on_card_matches_plain(i, bf16):
    """The card's fast blocks (cuDNN's bf16 convolution, the float32-output
    products of the f32 block's backward) against fast_block_plain on the
    card, at the headline length, with the bars of the CPU test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tp = port_random_xv_plda_params(np.random.default_rng(0),
                                    device="cuda").tdnn
    x, g, args = _block_case(tp, i, bf16, b=8, t=300, device="cuda")
    out, dx, mask = _block_and_grad(x, g, args, bf16)
    p_out, p_dx = TT.fast_block_plain(x, *args, g, bf16, mask)
    _assert_block_close(out, dx, p_out, p_dx, args, bf16)


@pytest.mark.parametrize("i", LAYERS)
def test_conv1d_matches_torch_conv1d(i):
    """_conv1d (one GEMM over the taps, (B, T, C)) and its input cotangent
    against F.conv1d and F.conv_transpose1d in (B, C, T), in float32."""
    k, dil, cout = TT.TDNN_SPEC[i]
    cin = 30 if i == 0 else TT.TDNN_SPEC[i - 1][2]
    gen = torch.Generator().manual_seed(i)
    x = torch.randn(2, 50, cin, generator=gen)
    w = torch.randn(cout, cin, k, generator=gen)
    b = torch.randn(cout, generator=gen)
    y = TT._conv1d(x, w, b, dil)
    want = torch.nn.functional.conv1d(x.transpose(1, 2), w, b, dilation=dil)
    _f32_close(y.numpy(), want.transpose(1, 2).numpy())
    gy = torch.randn(y.shape, generator=gen)
    gx = TT._conv1d_input_grad(gy, w, dil)
    want = torch.nn.functional.conv_transpose1d(gy.transpose(1, 2), w,
                                                dilation=dil)
    assert gx.shape == x.shape
    _f32_close(gx.numpy(), want.transpose(1, 2).numpy())


@pytest.mark.parametrize("i", LAYERS)
def test_card_backward_products_match_transposed_conv(monkeypatch, i):
    """_BlockFast's backward as it runs on the card (bf16 operands, one GEMM
    with a float32 output) run on the CPU, with torch.mm's float32-output
    form, which exists only on CUDA, computed as a float32 product of the
    same bf16 values: one transposed convolution of the bf16-rounded
    operands at f32 round-off."""
    k, dil, cout = TT.TDNN_SPEC[i]
    cin = 30 if i == 0 else TT.TDNN_SPEC[i - 1][2]
    gen = torch.Generator().manual_seed(i)
    gy = torch.randn(2, 40, cout, generator=gen).bfloat16()
    w = torch.randn(cout, cin, k, generator=gen).bfloat16()
    mm = torch.mm

    def mm_f32_out(a, b, out_dtype):
        assert a.dtype == b.dtype == torch.bfloat16
        assert out_dtype == torch.float32
        return mm(a.float(), b.float())

    monkeypatch.setattr(torch, "mm", mm_f32_out)
    got = TT._conv1d_input_grad(gy, w, dil, out_dtype=torch.float32)
    monkeypatch.undo()
    want = torch.nn.functional.conv_transpose1d(
        gy.float().transpose(1, 2), w.float(), dilation=dil).transpose(1, 2)
    assert got.dtype == torch.float32
    _f32_close(got.numpy(), want.numpy())
