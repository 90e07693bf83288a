"""Fused GMM Baum-Welch statistics of the fast attack-gradient path: CUDA
kernels + plain versions, forward and backward.

Port of the Pallas TPU kernels speakerguard_tpu/ops/pallas_gmm_stats.py
``_stats_fwd`` and ``_stats_bwd`` and of their custom VJP ``fused_stats``:

    loglike[b,t,c] = gconsts[c] + aug16(x_bt) . proj16[:, c]
    posts          = softmax_c(loglike)
    zeroth[b,c]    = sum_t posts[b,t,c]
    first[b,c,d]   = sum_t posts16[b,t,c] x16[b,t,d]

with bf16 operands and f32 accumulation, and the bf16 posteriors posts16 as
the only residual of the backward.  The rounding points, which kernel and
plain version share (the JAX kernels run in interpret mode are the
reference):

  1. x16 = bf16(x); aug16 = [x16, bf16(x16[r] x16[c])].
  2. loglike = f32-accumulated aug16 . proj16 + gconsts.
  3. posts in f32; zeroth = sum_t posts in f32; first = posts16^T x16.
  4. backward: dp = dz + x16 . bf16(df)^T; dl = posts (dp - sum_c posts dp)
     with posts = f32(posts16); daug = bf16(dl) . proj16^T; dx = chain(daug,
     unrounded x) + daug[:, :D] + posts16 . bf16(df).

The plain versions emulate "bf16 operands, f32 accumulation" by up-casting
the bf16-rounded operands to float32 before each product (a product of two
bf16 values is exact in float32).  ``stats_fwd``/``stats_bwd`` launch kernels
B and C of ``csrc/gmm.cu`` on CUDA tensors and run the plain versions on CPU
tensors.
"""

import torch

from speakerguard_tpu_torch.ops._build import KernelWrapper, check_rc
from speakerguard_tpu_torch.ops.gmm_loglike import (_library, check_operands,
                                                    packed_indices,
                                                    pair_table)

C_TILE = 128  # components per block of kernel B (its softmax partials)
ROW_TILE = 64  # frames per block of kernel C's daug launch, and F columns
BLOCKS_WANTED = 1056  # 8 blocks' worth per SM of an H100's 132


def bwd_splits(rows: int, d: int) -> int:
    """Blocks that share one 64-row tile's F tiles in kernel C's daug
    launch: enough to give the card ~1000 blocks when the batch alone
    gives few, at most one F tile each.  Their partial dx sum in a fixed
    order."""
    n_ft = -(-(d + d * (d + 1) // 2) // ROW_TILE)
    return max(1, min(n_ft, BLOCKS_WANTED // -(-rows // ROW_TILE)))


def _bf(t: torch.Tensor) -> torch.Tensor:
    """bf16-rounded values, held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def chain_plain(dq: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """VJP of the packed outer product: dq (..., P) -> dx (..., D) with
    dx_r += dq_p x_c and dx_c += dq_p x_r for p = (r, c), in float32."""
    rows, cols = packed_indices(x.shape[-1], x.device)
    dx = torch.zeros_like(x)
    dx.index_add_(-1, rows, dq * x[..., cols])
    dx.index_add_(-1, cols, dq * x[..., rows])
    return dx


def posteriors_plain(x: torch.Tensor, proj16: torch.Tensor,
                     gconsts: torch.Tensor) -> torch.Tensor:
    """The float32 posteriors (B, T, C) of rounding points 1-3."""
    x16 = _bf(x)
    rows, cols = packed_indices(x.shape[-1], x.device)
    aug16 = torch.cat([x16, _bf(x16[..., rows] * x16[..., cols])], dim=-1)
    loglike = aug16 @ proj16.to(torch.float32) + gconsts
    e = torch.exp(loglike - loglike.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def stats_fwd_plain(x: torch.Tensor, proj16: torch.Tensor,
                    gconsts: torch.Tensor):
    """x (B, T, D) f32, proj16 (F, C) bf16, gconsts (C,) f32 ->
    (zeroth (B, C) f32, first (B, C, D) f32, posts16 (B, T, C) bf16)."""
    posts = posteriors_plain(x, proj16, gconsts)
    posts16 = posts.to(torch.bfloat16)
    first = posts16.to(torch.float32).mT @ _bf(x)
    return posts.sum(dim=-2), first, posts16


def stats_bwd_plain(x: torch.Tensor, proj16: torch.Tensor,
                    posts16: torch.Tensor, dzeroth: torch.Tensor,
                    dfirst: torch.Tensor) -> torch.Tensor:
    """The input cotangent dx (B, T, D) f32 from the forward's posts16 and
    the cotangents dzeroth (B, C), dfirst (B, C, D)."""
    d = x.shape[-1]
    df16 = _bf(dfirst)
    dp = dzeroth[:, None, :] + _bf(x) @ df16.mT
    posts = posts16.to(torch.float32)
    dl = posts * (dp - (posts * dp).sum(dim=-1, keepdim=True))
    daug = _bf(dl) @ proj16.to(torch.float32).T
    dx = chain_plain(daug[..., d:], x) + daug[..., :d]
    return dx + posts @ df16


def _check(x, proj16, gconsts):
    check_operands(x, proj16, gconsts, torch.bfloat16)
    if x.ndim != 3 or 0 in x.shape:
        raise ValueError(f"expected x (B, T, D) with B, T, D >= 1, got "
                         f"{tuple(x.shape)}")


class _StatsFwd(KernelWrapper):
    """``stats_fwd(x, proj16, gconsts) -> (zeroth, first, posts16)``."""

    name = "stats_fwd"

    def __call__(self, x, proj16, gconsts):
        _check(x, proj16, gconsts)
        if not self.route(x):
            return stats_fwd_plain(x, proj16, gconsts)
        b, t, d = x.shape
        c = proj16.shape[1]
        dev = x.device
        xc, projc, gc = (t.contiguous() for t in (x, proj16, gconsts))
        pairs = pair_table(d, dev)
        zeroth = torch.empty((b, c), dtype=torch.float32, device=dev)
        first = torch.empty((b, c, d), dtype=torch.float32, device=dev)
        posts16 = torch.empty((b, t, c), dtype=torch.bfloat16, device=dev)
        part = torch.empty((b, t, -(-c // C_TILE), 2), dtype=torch.float32,
                           device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _library().sg_stats_fwd(
                xc.data_ptr(), projc.data_ptr(), gc.data_ptr(),
                pairs.data_ptr(), part.data_ptr(),
                zeroth.data_ptr(), first.data_ptr(), posts16.data_ptr(), b, t,
                d, c, stream)
        check_rc(rc, self.name)
        self.launches += 1
        return zeroth, first, posts16


class _StatsBwd(KernelWrapper):
    """``stats_bwd(x, proj16, posts16, dzeroth, dfirst) -> dx``."""

    name = "stats_bwd"

    def __call__(self, x, proj16, posts16, dzeroth, dfirst):
        b, t, d = x.shape
        c = proj16.shape[1]
        if (posts16.shape != (b, t, c) or posts16.dtype != torch.bfloat16
                or dzeroth.shape != (b, c) or dfirst.shape != (b, c, d)):
            raise ValueError(f"stats_bwd: posts16 {tuple(posts16.shape)} "
                             f"{posts16.dtype}, dzeroth "
                             f"{tuple(dzeroth.shape)}, dfirst "
                             f"{tuple(dfirst.shape)} do not fit x "
                             f"{tuple(x.shape)} and C={c}")
        dzeroth = dzeroth.to(torch.float32)
        dfirst = dfirst.to(torch.float32)
        if not self.route(x):
            return stats_bwd_plain(x, proj16, posts16, dzeroth, dfirst)
        dev = x.device
        args = [a.contiguous() for a in (x, proj16, posts16, dzeroth,
                                         dfirst)]
        pairs = pair_table(d, dev)
        splits = bwd_splits(b * t, d)
        dl16 = torch.empty((b, t, c), dtype=torch.bfloat16, device=dev)
        direct = torch.empty((b, t, d), dtype=torch.float32, device=dev)
        part = torch.empty((splits, b, t, d), dtype=torch.float32,
                           device=dev)
        dx = torch.empty((b, t, d), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _library().sg_stats_bwd(
                *(a.data_ptr() for a in args), pairs.data_ptr(),
                dl16.data_ptr(), direct.data_ptr(), part.data_ptr(),
                dx.data_ptr(), b, t, d, c, splits, stream)
        check_rc(rc, self.name)
        self.launches += 1
        return dx


stats_fwd = _StatsFwd()
stats_bwd = _StatsBwd()


class _FusedStats(torch.autograd.Function):
    """(zeroth, first) = fused_stats(proj16, gconsts, feats), differentiable
    in feats only: the forward saves posts16, the backward is ``stats_bwd``
    and returns None for the GMM parameters (never attack variables)."""

    @staticmethod
    def forward(ctx, proj16, gconsts, feats):
        zeroth, first, posts16 = stats_fwd(feats, proj16, gconsts)
        ctx.save_for_backward(proj16, feats, posts16)
        return zeroth, first

    @staticmethod
    def backward(ctx, dzeroth, dfirst):
        proj16, feats, posts16 = ctx.saved_tensors
        return None, None, stats_bwd(feats, proj16, posts16, dzeroth, dfirst)


def fused_stats(proj16: torch.Tensor, gconsts: torch.Tensor,
                feats: torch.Tensor):
    """feats (B, T, D) -> (zeroth (B, C), first (B, C, D)), fused."""
    return _FusedStats.apply(proj16, gconsts, feats)
