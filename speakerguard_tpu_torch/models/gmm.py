"""Full-covariance GMM (UBM) Baum-Welch statistics, batched.

Port of speakerguard_tpu/models/gmm.py (reference model/_iv_plda/gmm.py).
The frame log-likelihood

    loglike[t,c] = gconsts[c] + m_ic[c]·x_t - 0.5 x_t^T InvCov_c x_t

is one matmul through the packed-symmetric-quadratic augmentation: with
w' = InvCov * (2 - I),

    loglike = [x, packed(x x^T)] @ [m_ic, -0.5 w']^T + gconsts

where packed() takes the upper triangle in ``np.triu_indices`` order.

Two paths, as in the JAX package:

  * exact (scores and every success decision): float32, the augmentation
    and its VJP as one-hot / indicator matmuls (``augment``, ``aug_chain``),
    the (B, T, C) loglike under an analytic VJP (``_LoglikeFused``), whose
    forward runs the fused kernel ``ops/gmm_loglike.py`` when asked;
  * fast (attack gradients only, ``FastPath``): the bf16 copy of quad_proj,
    bf16 operands with f32 accumulation on the card (``fast_dot_dtype``),
    the softmax + stats block under one hand-written VJP with bf16 saved
    posteriors (``_SoftmaxStatsFast``), an optional frame-chunked variant,
    the fused stats kernels ``ops/gmm_stats.py``, and a frozen batch-shared
    top-K Gaussian selection (``make_topk_context``).
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.ops.gmm_loglike import fused_loglike
from speakerguard_tpu_torch.ops.gmm_stats import fused_stats


class FullGMMParams(NamedTuple):
    gconsts: torch.Tensor          # (C,)
    weights: torch.Tensor          # (C,)
    means_invcovars: torch.Tensor  # (C, D)
    invcovars: torch.Tensor        # (C, D, D) symmetric
    means: torch.Tensor            # (C, D) = InvCov^-1 @ means_invcovars
    quad_proj: torch.Tensor        # (D + D(D+1)//2, C) packed projection
    # bf16 copy of quad_proj for the fast path (None: cast when needed)
    quad_proj_bf16: torch.Tensor | None = None

    @property
    def num_gaussians(self) -> int:
        return self.gconsts.shape[0]

    @property
    def dim(self) -> int:
        return self.means_invcovars.shape[1]


def build_gmm(gconsts: np.ndarray, weights: np.ndarray,
              means_invcovars: np.ndarray, invcovars: np.ndarray,
              device=None, fast_copies: bool | None = None) -> FullGMMParams:
    """Host-side preprocessing at model load: derive the means and the
    packed quadratic projection matrix (float64 numpy, stored float32).
    ``fast_copies`` (default: on a CUDA device, where the fast path runs by
    default) also stores the bf16 copy of the projection."""
    dev = resolve_device(device)
    c, d = means_invcovars.shape
    means = np.linalg.solve(invcovars, means_invcovars[..., None])[..., 0]
    rows, cols = np.triu_indices(d)
    w = invcovars * np.where(np.eye(d, dtype=bool), 1.0, 2.0)
    packed = w[:, rows, cols]                      # (C, D(D+1)/2)
    proj = np.ascontiguousarray(
        np.concatenate([means_invcovars, -0.5 * packed], axis=1).T)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    quad_proj = f32(proj)
    if fast_copies is None:
        fast_copies = dev.type == "cuda"
    return FullGMMParams(
        gconsts=f32(gconsts), weights=f32(weights),
        means_invcovars=f32(means_invcovars), invcovars=f32(invcovars),
        means=f32(means), quad_proj=quad_proj,
        quad_proj_bf16=quad_proj.to(torch.bfloat16) if fast_copies else None)


def random_gmm(rng: np.random.Generator, num_gaussians: int = 2048,
               dim: int = 60, device=None) -> FullGMMParams:
    """Random but well-conditioned GMM fixture; draws the same numbers from
    ``rng`` as the JAX package's random_gmm."""
    a = rng.standard_normal((num_gaussians, dim, dim)) * 0.1
    invcov = np.einsum("cij,ckj->cik", a, a) + np.eye(dim) * 1.0
    means = rng.standard_normal((num_gaussians, dim))
    mic = np.einsum("cij,cj->ci", invcov, means)
    _, logdet = np.linalg.slogdet(invcov)
    weights = np.full(num_gaussians, 1.0 / num_gaussians)
    # Kaldi gconst = log(weight) + 0.5 logdet(InvCov) - 0.5 (D log(2pi) + m^T InvCov m)
    gconsts = (np.log(weights) + 0.5 * logdet
               - 0.5 * (dim * np.log(2 * np.pi)
                        + np.einsum("ci,ci->c", means, mic)))
    return build_gmm(gconsts, weights, mic, invcov, device=device)


def fast_proj(params: FullGMMParams) -> torch.Tensor:
    """bf16 quad_proj: the stored copy, else the same rounding cast here."""
    qp = params.quad_proj_bf16
    return qp if qp is not None else params.quad_proj.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# precision of the fast path
# ---------------------------------------------------------------------------

def fast_dot_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card; float32 on the CPU.  The JAX package has bf16 on
    the TPU and float32 elsewhere (gmm.py fast_dot_dtype): off the
    accelerator the operands are still the bf16-ROUNDED weight copies, so
    the CPU tests see the same weight rounding as JAX's CPU run."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if b.ndim == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.bmm(a, b, out_dtype=torch.float32)


class _DotF32(torch.autograd.Function):
    """The bf16 product of ``dot_f32`` under autograd (the out_dtype GEMM
    has no derivative of its own): each input's cotangent is the same kind
    of product, the f32 cotangent rounded to bf16, rounded to the input's
    dtype as JAX's transpose of a preferred_element_type dot does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_f32(g, b.mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.ndim == 2:
                gb = _mm_f32(a.reshape(-1, a.shape[-1]).T,
                             g.reshape(-1, g.shape[-1]))
            else:
                gb = _mm_f32(a.mT, g)
            gb = gb.to(b.dtype)
        return ga, gb


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation and a float32 result (JAX's
    ``preferred_element_type=float32``).  bf16 operands go to a bf16 GEMM
    with an f32 output (``out_dtype``); a (..., M, K) @ (K, N) product is
    flattened to one GEMM, (B, M, K) @ (B, K, N) is a batched one."""
    if a.dtype != torch.bfloat16:
        return a @ b
    return _DotF32.apply(a, b)


# ---------------------------------------------------------------------------
# the augmentation aug(x) = [x, packed(x x^T)] and its VJP
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _aug_ops(d: int, device: torch.device, dtype: torch.dtype):
    """One-hot (D, P) selectors of x[rows] and x[cols] for the forward, and
    their (P, D) transposes for the chain rule, on the device.  Selection by
    a one-hot matmul is exact at any precision: one nonzero term per
    output."""
    rows, cols = np.triu_indices(d)
    p = len(rows)
    g_rows = np.zeros((p, d), np.float32)
    g_rows[np.arange(p), rows] = 1.0
    g_cols = np.zeros((p, d), np.float32)
    g_cols[np.arange(p), cols] = 1.0
    return tuple(torch.as_tensor(m, device=device).to(dtype) for m in
                 (g_rows.T.copy(), g_cols.T.copy(), g_rows, g_cols))


def _augment_fwd(x: torch.Tensor) -> torch.Tensor:
    sel_r, sel_c, _, _ = _aug_ops(x.shape[-1], x.device, x.dtype)
    return torch.cat([x, (x @ sel_r) * (x @ sel_c)], dim=-1)


def aug_chain(x: torch.Tensor, cot: torch.Tensor,
              fast: bool = False) -> torch.Tensor:
    """VJP of ``augment``: dx = cot[:, :D] + the packed outer product's
    chain rule (dx_r += dq_p x_c, dx_c += dq_p x_r) as two (P, D) indicator
    matmuls.  fast=True: x and dq enter the products in the fast dtype (the
    JAX chain's fast branch)."""
    d = x.shape[-1]
    dlin = cot[..., :d].to(torch.float32)
    dq = cot[..., d:]
    if fast:
        dt = fast_dot_dtype(x.device)
        x, dq = x.to(dt), dq.to(dt)
    sel_r, sel_c, g_rows, g_cols = _aug_ops(d, x.device, x.dtype)
    dx = dlin + dot_f32(dq * (x @ sel_c), g_rows)
    return dx + dot_f32(dq * (x @ sel_r), g_cols)


class _Augment(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _augment_fwd(x)

    @staticmethod
    def backward(ctx, cot):
        (x,) = ctx.saved_tensors
        return aug_chain(x, cot)


def augment(x: torch.Tensor) -> torch.Tensor:
    """aug(x) = [x, packed(x x^T)]: (..., D) -> (..., D + D(D+1)/2), with
    the indicator-matmul VJP instead of a gather's scatter-add backward."""
    return _Augment.apply(x)


# ---------------------------------------------------------------------------
# the (B, T, C) loglike: exact (optionally the fused kernel) and fast
# ---------------------------------------------------------------------------

class _LoglikeFused(torch.autograd.Function):
    """Exact 3-D loglike.  Forward: the fused kernel (``kernel``) or
    aug(x) @ quad_proj + gconsts.  Backward, analytic: daug = gbar
    quad_proj^T, then the augmentation's chain rule; the GMM parameters get
    no gradient (never attack variables)."""

    @staticmethod
    def forward(ctx, quad_proj, gconsts, feats, kernel):
        ctx.save_for_backward(quad_proj, feats)
        if kernel:
            return fused_loglike(feats, quad_proj, gconsts)
        return _augment_fwd(feats) @ quad_proj + gconsts

    @staticmethod
    def backward(ctx, gbar):
        quad_proj, feats = ctx.saved_tensors
        return None, None, aug_chain(feats, gbar @ quad_proj.T), None


class _LoglikeFast(torch.autograd.Function):
    """Fast 3-D loglike: aug of the fast-dtype features against the bf16
    projection, f32 accumulation; the cotangent daug is emitted in the fast
    dtype (JAX gmm.py _loglike_fast)."""

    @staticmethod
    def forward(ctx, proj16, gconsts, feats):
        ctx.save_for_backward(proj16, feats)
        dt = fast_dot_dtype(feats.device)
        aug = _augment_fwd(feats.to(dt))
        return dot_f32(aug, proj16.to(dt)) + gconsts

    @staticmethod
    def backward(ctx, gbar):
        proj16, feats = ctx.saved_tensors
        dt = fast_dot_dtype(feats.device)
        daug = gbar.to(dt) @ proj16.to(dt).T
        return None, None, aug_chain(feats, daug, fast=True)


def component_loglike(params: FullGMMParams, feats: torch.Tensor,
                      fast: bool = False, kernel: bool = False
                      ) -> torch.Tensor:
    """feats: (..., T, D) -> per-component loglike (..., T, C).

    A (B, T, D) input runs under an analytic VJP: the fast variant when
    ``fast`` (attack gradients only), else the exact one, whose forward is
    the fused kernel when ``kernel``."""
    if feats.ndim == 3:
        if fast:
            return _LoglikeFast.apply(fast_proj(params), params.gconsts,
                                      feats)
        return _LoglikeFused.apply(params.quad_proj, params.gconsts, feats,
                                   kernel)
    return augment(feats) @ params.quad_proj + params.gconsts


# ---------------------------------------------------------------------------
# fast stats: loglike -> softmax -> (zeroth, first) under one VJP
# ---------------------------------------------------------------------------

class _SoftmaxStatsFast(torch.autograd.Function):
    """The forward saves the posteriors in the fast dtype (bf16 on the
    card) and the backward writes the softmax VJP by hand, so every large
    operand enters its product pre-rounded (JAX gmm.py
    _softmax_stats_fast)."""

    @staticmethod
    def forward(ctx, proj16, gconsts, feats):
        dt = fast_dot_dtype(feats.device)
        feats16 = feats.to(dt)
        loglike = dot_f32(_augment_fwd(feats16), proj16.to(dt)) + gconsts
        posts = torch.softmax(loglike, dim=-1)
        posts16 = posts.to(dt)
        ctx.save_for_backward(proj16, feats, posts16)
        return posts.sum(dim=-2), dot_f32(posts16.mT, feats16)

    @staticmethod
    def backward(ctx, dzeroth, dfirst):
        proj16, feats, posts16 = ctx.saved_tensors
        dt = fast_dot_dtype(feats.device)
        df16 = dfirst.to(dt)
        # dposts[b,t,c] = dzeroth[b,c] + sum_d dfirst[b,c,d] feats[b,t,d]
        dp = dzeroth[:, None, :] + dot_f32(feats.to(dt), df16.mT)
        posts = posts16.to(torch.float32)
        dl = posts * (dp - (posts * dp).sum(dim=-1, keepdim=True))
        daug = dl.to(dt) @ proj16.to(dt).T
        grad = aug_chain(feats, daug, fast=True)
        # the feats appearance inside `first`
        return None, None, grad + dot_f32(posts16, df16)


def _softmax_stats_fast_chunked(proj16, gconsts, feats, t_chunk):
    """_SoftmaxStatsFast over T-chunks, summing the (B, C) / (B, C, D)
    statistics in float32 (JAX gmm.py _softmax_stats_fast_chunked)."""
    b, t, d = feats.shape
    c = proj16.shape[-1]
    z = torch.zeros((b, c), dtype=torch.float32, device=feats.device)
    f = torch.zeros((b, c, d), dtype=torch.float32, device=feats.device)
    for t0 in range(0, t, t_chunk):
        zc, fc = _SoftmaxStatsFast.apply(proj16, gconsts,
                                         feats[:, t0:t0 + t_chunk])
        z, f = z + zc, f + fc
    return z, f


def _stats_fast(proj16, gconsts, feats, t_chunk: int):
    if t_chunk and feats.shape[1] > t_chunk:
        return _softmax_stats_fast_chunked(proj16, gconsts, feats, t_chunk)
    return _SoftmaxStatsFast.apply(proj16, gconsts, feats)


# ---------------------------------------------------------------------------
# top-K Gaussian selection, frozen per attack run
# ---------------------------------------------------------------------------

class GmmTopKContext(NamedTuple):
    """Frozen batch-shared Gaussian selection for one attack run."""
    sel: torch.Tensor          # (K,) component ids, unique
    proj_sel: torch.Tensor     # (F_aug, K) bf16 projection columns
    gconsts_sel: torch.Tensor  # (K,)


@torch.no_grad()
def make_topk_context(params: FullGMMParams, feats: torch.Tensor,
                      k: int, shard=None) -> GmmTopKContext | None:
    """One full-C fast loglike pass on the (clean) features -> the shared
    top-K components, ranked by the max over utterances of their
    per-utterance posterior-mass fraction.  None when K <= 0 or K >= C
    (selection is a no-op).  ``shard`` (a ``parallel.mesh.BatchShard``):
    ``feats`` are this rank's utterances, and the max over utterances is
    all-reduced over the ranks before the top K are taken (as GSPMD
    reduces it over the sharded batch in JAX), so every rank freezes the
    same components."""
    if k <= 0 or k >= params.num_gaussians:
        return None
    dt = fast_dot_dtype(feats.device)
    proj16 = fast_proj(params)
    loglike = dot_f32(_augment_fwd(feats.to(dt)),
                      proj16.to(dt)) + params.gconsts
    frac = torch.softmax(loglike, dim=-1).mean(dim=-2)        # (B, C)
    score = frac.amax(dim=0)                                  # (C,)
    if shard is not None:
        score = shard.max(score)
    sel = torch.topk(score, k).indices                        # (K,)
    return GmmTopKContext(sel=sel,
                          proj_sel=proj16.index_select(1, sel).contiguous(),
                          gconsts_sel=params.gconsts.index_select(0, sel))


# ---------------------------------------------------------------------------
# statistics dispatch
# ---------------------------------------------------------------------------

def zeroth_first_stats(params: FullGMMParams, feats: torch.Tensor,
                       fast: FastPath | None = None,
                       topk_ctx: GmmTopKContext | None = None,
                       loglike_kernel: bool = False):
    """feats: (B, T, D) -> (zeroth (B, C), first (B, C, D)).

    Matches reference gmm.py:166-171 without the frame-batching loop.
    ``fast`` (a FastPath; None = exact) runs the attack-gradient variant:
    with ``topk_ctx`` the selected-K subspace (SELECTED-space stats
    (B, K) / (B, K, D), consumed by ivector.IvectorTopK), else the fused
    stats kernels when ``fast.stats_kernel``, else the unfused block.  The
    top-K context wins, as in JAX gmm.py:616-627, so the kernels run only
    with gmm_topk=0.  On the exact path ``loglike_kernel`` routes the
    loglike through the fused kernel."""
    if fast is not None and topk_ctx is not None:
        return _stats_fast(topk_ctx.proj_sel, topk_ctx.gconsts_sel, feats,
                           fast.stats_t_chunk)
    if fast is not None:
        if fast.stats_kernel:
            return fused_stats(fast_proj(params), params.gconsts, feats)
        return _stats_fast(fast_proj(params), params.gconsts, feats,
                           fast.stats_t_chunk)
    posts = torch.softmax(component_loglike(params, feats,
                                            kernel=loglike_kernel), dim=-1)
    return posts.sum(dim=-2), torch.einsum("btc,btd->bcd", posts, feats)
