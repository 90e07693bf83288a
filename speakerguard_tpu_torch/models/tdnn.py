"""x-vector TDNN: five dilated conv1d + ReLU + BatchNorm layers, stats pooling.

Port of speakerguard_tpu/models/tdnn.py (reference
model/_xv_plda/xvecTDNN.py).  The weights are held in PyTorch's layout:
Conv1d weights (out, in, k) and Linear weights (out, in), as the reference
checkpoint stores them, so ``load_tdnn_from_torch_state`` takes a state dict
as it is.  The activations keep the JAX package's (B, T, C) layout, and each
dilated convolution runs as one GEMM over its k taps (``_im2col`` gathers
the k shifted copies of the input side by side).  Like XLA's convolutions,
the GEMM accumulates in float32 and rounds once to its output type, and it
gives the float32-output bf16 products of ``_BlockFast``'s backward
(``torch.mm``'s out_dtype form), which no convolution call offers; on the
H100 cuDNN's bf16 backward of the dilated 7-tap layer also ran about ten
times slower than the GEMM at batch 512.
BatchNorm1d(affine=False) is a normalise with the running stats; stats
pooling is mean ++ unbiased std over time.

The fast attack-gradient path (``FastPath.tdnn_fast``, JAX SG_TDNN_FAST)
runs each conv -> ReLU -> BN layer as one ``torch.autograd.Function`` that
saves the bool ReLU mask in place of the activations, and the stats pooling
as one that saves its input in bf16.  With ``FastPath.tdnn_bf16_act`` (JAX
SG_TDNN_BF16_ACT) the activations and their cotangents are bf16 between the
layers.  The forward values of the f32 blocks are the exact path's.  The
weights are buffers: the Functions give them no cotangent, since attacks
differentiate with respect to the waveform only.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models.gmm import fast_dot_dtype

# (kernel, dilation, out_channels) for tdnn1..tdnn5; input channels = 30
TDNN_SPEC = ((5, 1, 512), (5, 2, 512), (7, 3, 512), (1, 1, 512), (1, 1, 1500))
BN_EPS = 1e-5


class BNStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


class TDNNParams(NamedTuple):
    conv_w: tuple            # 5 x (out, in, k)
    conv_b: tuple            # 5 x (out,)
    bn_tdnn: tuple           # 5 x BNStats
    fc1_w: torch.Tensor      # (512, 3000)
    fc1_b: torch.Tensor
    bn_fc1: BNStats
    fc2_w: torch.Tensor      # (512, 512)
    fc2_b: torch.Tensor
    bn_fc2: BNStats
    fc3_w: torch.Tensor      # (num_spks, 512)
    fc3_b: torch.Tensor


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _bn_stats(cout, dev) -> BNStats:
    return BNStats(torch.zeros(cout, device=dev), torch.ones(cout, device=dev))


def random_tdnn(rng: np.random.Generator, num_spks: int = 251,
                in_dim: int = 30, device=None) -> TDNNParams:
    """Random weights drawn from ``rng`` in the JAX package's order and
    shapes ((k, in, out) convs, (in, out) linears), then transposed to
    PyTorch's layout: one seed gives the same weights in both packages."""
    dev = resolve_device(device)
    ws, bs, bns = [], [], []
    cin = in_dim
    for k, _, cout in TDNN_SPEC:
        bound = 1.0 / np.sqrt(cin * k)
        ws.append(_tensor(rng.uniform(-bound, bound, (k, cin, cout))
                          .transpose(2, 1, 0), dev))
        bs.append(_tensor(rng.uniform(-bound, bound, cout), dev))
        bns.append(_bn_stats(cout, dev))
        cin = cout

    def lin(i, o):
        bound = 1.0 / np.sqrt(i)
        return (_tensor(rng.uniform(-bound, bound, (i, o)).T, dev),
                _tensor(rng.uniform(-bound, bound, o), dev))

    fc1_w, fc1_b = lin(3000, 512)
    fc2_w, fc2_b = lin(512, 512)
    fc3_w, fc3_b = lin(512, num_spks)
    return TDNNParams(tuple(ws), tuple(bs), tuple(bns),
                      fc1_w, fc1_b, _bn_stats(512, dev),
                      fc2_w, fc2_b, _bn_stats(512, dev),
                      fc3_w, fc3_b)


def _bn(x, stats: BNStats, eps=BN_EPS):
    """Normalise with running stats; channels on the last axis."""
    return (x - stats.mean) * torch.rsqrt(stats.var + eps)


def _im2col(x, k, dilation, t_out):
    """(B, T, C) -> (B t_out, k C): row (b, t) holds x[b, t + j dilation]
    for the k taps j, tap-major."""
    if k == 1:
        return x[:, :t_out].reshape(-1, x.shape[-1])
    return torch.cat([x[:, j * dilation:j * dilation + t_out]
                      for j in range(k)], dim=-1).view(-1, k * x.shape[-1])


def _mm(a, b, out_dtype):
    """a @ b; with ``out_dtype`` wider than the operands, the float32
    output of bf16 operands (``torch.mm``'s out_dtype form, CUDA only)."""
    if out_dtype == a.dtype:
        return a @ b
    return torch.mm(a, b, out_dtype=out_dtype)


def _conv1d(x, w, bias, dilation):
    """Valid dilated convolution in (B, T, C): x (B, T, in) and w (out, in,
    k), both of one dtype -> (B, T - (k-1) dilation, out), as one GEMM over
    the k taps with float32 accumulation, rounded once to that dtype."""
    k = w.shape[2]
    t_out = x.shape[1] - (k - 1) * dilation
    wm = w.permute(2, 1, 0).reshape(-1, w.shape[0])        # (k in, out)
    y = _im2col(x, k, dilation, t_out) @ wm
    y = y.view(x.shape[0], t_out, -1)
    return y if bias is None else y + bias


def _conv1d_input_grad(gy, w, dilation, out_dtype=None):
    """The input cotangent of ``_conv1d``: gy (B, T', out) and w of gy's
    dtype -> (B, T' + (k-1) dilation, in), the convolution of gy padded by
    (k-1) dilation on both sides with the taps reversed, as one GEMM
    rounded once to ``out_dtype`` (default gy's)."""
    k = w.shape[2]
    pad = (k - 1) * dilation
    t_in = gy.shape[1] + pad
    gyp = F.pad(gy, (0, 0, pad, pad)) if pad else gy
    wm = w.flip(2).permute(2, 0, 1).reshape(-1, w.shape[1])
    gx = _mm(_im2col(gyp, k, dilation, t_in), wm, out_dtype or gy.dtype)
    return gx.view(gy.shape[0], t_in, -1)


class _BlockFast(torch.autograd.Function):
    """conv -> ReLU -> BN for attack-gradient graphs (JAX ``_block_fast``):
    the exact float32 forward, with only the bool ReLU mask, the weights and
    the BN variance saved; the backward is one transposed convolution on
    operands in the fast dtype (bf16 on the card) with a float32 output."""

    @staticmethod
    def forward(ctx, x, w, b, mean, var, dilation):
        y = _conv1d(x, w, b, dilation)
        mask = y > 0
        out = _bn(torch.where(mask, y, 0.0), BNStats(mean, var))
        ctx.save_for_backward(mask, w, var)
        ctx.dilation = dilation
        return out

    @staticmethod
    def backward(ctx, g):
        mask, w, var = ctx.saved_tensors
        dt = fast_dot_dtype(g.device)
        gy = torch.where(mask, g * torch.rsqrt(var + BN_EPS), 0.0)
        gx = _conv1d_input_grad(gy.to(dt), w.to(dt), ctx.dilation,
                                out_dtype=torch.float32)
        return gx, None, None, None, None, None


class _BlockFastBf16(torch.autograd.Function):
    """conv -> ReLU -> BN with bf16 activations (JAX ``_block_fast_bf16``,
    bf16 on every backend): x arrives bf16, the conv takes bf16 weights and
    rounds its float32 sum once to bf16, the bias, ReLU and BN run in
    float32 on that and the result is rounded to bf16.  The backward is a
    bf16 transposed convolution, its float32 sum rounded once to bf16."""

    @staticmethod
    def forward(ctx, x, w, b, mean, var, dilation):
        w16 = w.to(torch.bfloat16)
        y = torch.add(_conv1d(x, w16, None, dilation), b)   # float32
        mask = y > 0
        out = _bn(torch.where(mask, y, 0.0), BNStats(mean, var))
        ctx.save_for_backward(mask, w16, var)
        ctx.dilation = dilation
        return out.to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        mask, w16, var = ctx.saved_tensors
        gy = torch.where(mask, g * torch.rsqrt(var + BN_EPS), 0.0)  # float32
        gx = _conv1d_input_grad(gy.to(torch.bfloat16), w16, ctx.dilation)
        return gx, None, None, None, None, None


def fast_block_plain(x, w, b, mean, var, dilation, g, bf16, mask=None):
    """The plain version of ``_BlockFast`` (``bf16=False``) and
    ``_BlockFastBf16`` on (B, T, C) tensors: the block's own float32
    elementwise steps and roundings around convolutions that ``F.conv1d``
    and ``F.conv_transpose1d`` compute in float64 on the same operands
    (exact products, sums far inside the GEMMs' float32 round-off), each
    sum rounded to float32.  Returns (output, input cotangent for the
    output cotangent ``g``).  ``mask`` (the block's saved ReLU mask)
    replaces the plain forward's own in the backward: a conv output within
    round-off of 0 can take either sign in two sums of different order, and
    one flipped mask entry moves the cotangent by a whole term."""
    f64 = torch.float64
    dt = torch.bfloat16 if bf16 else fast_dot_dtype(x.device)
    w_fwd = w.to(torch.bfloat16) if bf16 else w
    y = F.conv1d(x.to(f64).transpose(1, 2), w_fwd.to(f64), None,
                 dilation=dilation).transpose(1, 2).float()
    if bf16:
        y = y.to(torch.bfloat16).float()
    y = y + b
    s = torch.rsqrt(var + BN_EPS)
    out = _bn(torch.where(y > 0, y, 0.0), BNStats(mean, var))
    mask = y > 0 if mask is None else mask
    gy = torch.where(mask, g.float() * s, 0.0).to(dt)
    gx = F.conv_transpose1d(gy.to(f64).transpose(1, 2), w.to(dt).to(f64),
                            dilation=dilation).transpose(1, 2).float()
    if bf16:
        return out.to(torch.bfloat16), gx.to(torch.bfloat16)
    return out, gx


def _mean_std(x32):
    """Mean ++ unbiased std over time (axis 1; torch.Tensor.std's
    correction=1), the variance clamped at 0 before the sqrt."""
    mean = torch.mean(x32, dim=1)
    std = torch.sqrt(torch.clamp(torch.var(x32, dim=1, correction=1),
                                 min=0.0))
    return mean, std


def _mean_std_vjp(g, x16, mean, std):
    """d mean / dx = 1/T; d std / dx = (x - mean) / ((T-1) std)."""
    t = x16.shape[1]
    c = mean.shape[-1]
    gm, gs = g[:, None, :c], g[:, None, c:]
    centered = x16.float() - mean[:, None, :]
    denom = torch.clamp((t - 1) * std, min=1e-12)[:, None, :]
    return gm / t + gs * centered / denom


class _StatsPoolFast(torch.autograd.Function):
    """Stats pooling of f32 activations (JAX ``_stats_pool_fast``): the
    residual is the input rounded to bf16 plus the f32 mean and std."""

    @staticmethod
    def forward(ctx, x):
        mean, std = _mean_std(x)
        ctx.save_for_backward(x.to(torch.bfloat16), mean, std)
        return torch.cat([mean, std], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _mean_std_vjp(g, *ctx.saved_tensors)


class _StatsPoolFastBf16(torch.autograd.Function):
    """Stats pooling of bf16 activations (JAX ``_stats_pool_fast_bf16``):
    float32 sums, a float32 (B, 3000) output, the bf16 input is its own
    residual and the cotangent goes back as bf16."""

    @staticmethod
    def forward(ctx, x):
        mean, std = _mean_std(x.float())
        ctx.save_for_backward(x, mean, std)
        return torch.cat([mean, std], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _mean_std_vjp(g, *ctx.saved_tensors).to(torch.bfloat16)


def _normal(rng, shape, device) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` from ``rng``: a
    torch.Generator, or a draw function ``rng(shape)``."""
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device=device)
    noise = torch.as_tensor(rng(tuple(shape)), dtype=torch.float32,
                            device=device)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)}, expected "
                         f"{tuple(shape)}")
    return noise


def tdnn_embedding(params: TDNNParams, feats: torch.Tensor,
                   fast=None, train: bool = False, rng=None,
                   noise_eps: float = 1e-5) -> torch.Tensor:
    """feats: (B, T, F=30) -> (B, 512) x-vector, fc1's pre-nonlinearity
    output (reference xvecTDNN.embedding).  ``fast`` (a ``FastPath``; None
    = exact) picks the fast blocks when its ``tdnn_fast`` is set, with bf16
    activations when ``tdnn_bf16_act`` is too.

    ``train=True`` runs the exact blocks (``fast`` is ignored) and, when
    ``rng`` is given, adds ``noise_eps`` times standard normal noise to the
    last block's output, as the JAX package's train mode does
    (speakerguard_tpu/models/tdnn.py:329-330).  ``rng``: a torch.Generator
    on the features' device, or ``draw(shape)``, a caller's draw function
    (the CPU tests pass JAX's ``normal(rng, x.shape)``)."""
    use_fast = fast is not None and fast.tdnn_fast and not train
    use_bf16 = use_fast and fast.tdnn_bf16_act
    x = feats.to(torch.bfloat16) if use_bf16 else feats
    block = _BlockFastBf16 if use_bf16 else _BlockFast
    for i, (_, dil, _) in enumerate(TDNN_SPEC):
        w, b, bn = params.conv_w[i], params.conv_b[i], params.bn_tdnn[i]
        if use_fast:
            x = block.apply(x, w, b, bn.mean, bn.var, dil)
        else:
            x = _bn(F.relu(_conv1d(x, w, b, dil)), bn)
    if train and rng is not None:
        x = x + noise_eps * _normal(rng, x.shape, x.device).to(x.dtype)
    if use_bf16:
        stats = _StatsPoolFastBf16.apply(x)
    elif use_fast:
        stats = _StatsPoolFast.apply(x)
    else:
        stats = torch.cat(_mean_std(x), dim=-1)            # (B, 3000)
    return F.linear(stats, params.fc1_w, params.fc1_b)


def tdnn_forward(params: TDNNParams, feats: torch.Tensor,
                 train: bool = False, rng=None) -> torch.Tensor:
    """The classifier head -> (B, num_spks) logits (reference
    xvecTDNN.forward); ``train``, ``rng``: ``tdnn_embedding``'s."""
    x = _bn(F.relu(tdnn_embedding(params, feats, train=train, rng=rng)),
            params.bn_fc1)
    x = _bn(F.relu(F.linear(x, params.fc2_w, params.fc2_b)), params.bn_fc2)
    return F.linear(x, params.fc3_w, params.fc3_b)


def load_tdnn_from_torch_state(state: dict, device=None) -> TDNNParams:
    """TDNNParams from a state dict of the reference checkpoint (tensors or
    numpy arrays), whose layout the port keeps as it is."""
    dev = resolve_device(device)

    def arr(k):
        v = state[k]
        return _tensor(v.detach().cpu().numpy() if hasattr(v, "detach")
                       else v, dev)

    def bn(name):
        return BNStats(arr(f"{name}.running_mean"), arr(f"{name}.running_var"))

    return TDNNParams(
        tuple(arr(f"tdnn{i}.weight") for i in range(1, 6)),
        tuple(arr(f"tdnn{i}.bias") for i in range(1, 6)),
        tuple(bn(f"bn_tdnn{i}") for i in range(1, 6)),
        arr("fc1.weight"), arr("fc1.bias"), bn("bn_fc1"),
        arr("fc2.weight"), arr("fc2.bias"), bn("bn_fc2"),
        arr("fc3.weight"), arr("fc3.bias"))
