"""i-vector extractor (total-variability T-matrix), batched.

Port of speakerguard_tpu/models/ivector.py (reference
model/_iv_plda/ivector_extract.py).  The per-utterance posterior-precision
system

    L = I + sum_c N_c  T_c^T Sigma_c^-1 T_c
    linear = sum_c T_c^T Sigma_c^-1 F_c
    ivector = L^-1 linear            (with Kaldi's prior-offset trick)

is evaluated with two load-time precomputations on the device:

  * ``quad_packed`` (C, IV(IV+1)/2): upper triangle of T_c^T Sigma_c^-1 T_c,
    so the packed L of a whole batch is one (B, C) @ (C, P) matmul;
  * ``proj`` (C, IV, D) = T_c^T Sigma_c^-1, so ``linear`` is one einsum.

The SPD solve factors L with the hand-written batched Cholesky
(ops/chol.py ``cholesky_rt``, or ``cholesky_rt_dinv``, or the fused
``chol_solve``, as ``spd_solver`` picks) and differentiates by the implicit
function theorem, reusing the forward's factor in the backward.  The fast
attack-gradient path (``FastPath``) reads bf16 copies of quad_packed and
proj, optionally restricted to a frozen top-K component selection
(``IvectorTopK``), assembles L in bf16 (``ivec_l_bf16``) and factors it
with bf16 trailing updates (``chol_bf16_updates``).
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.models.gmm import dot_f32, fast_dot_dtype
from speakerguard_tpu_torch.ops.chol import (DINV_M, chol_solve, cholesky_rt,
                                             cholesky_rt_dinv)
from speakerguard_tpu_torch.ops.trsv import triangular_solve_vec


class IvectorExtractorParams(NamedTuple):
    extractor_matrix: torch.Tensor  # (C, D, IV)   Kaldi "M"
    sigma_inv: torch.Tensor         # (C, D, D)
    offset: torch.Tensor            # scalar prior offset
    quad_packed: torch.Tensor       # (C, IV(IV+1)/2) upper-tri of T^T S^-1 T
    proj: torch.Tensor              # (C, IV, D)
    # bf16 copies for the fast path (None: cast when needed)
    quad_packed_bf16: torch.Tensor | None = None
    proj_bf16: torch.Tensor | None = None

    @property
    def num_gaussians(self):
        return self.extractor_matrix.shape[0]

    @property
    def dim(self):
        return self.extractor_matrix.shape[1]

    @property
    def ivector_dim(self):
        return self.extractor_matrix.shape[2]


def build_extractor(extractor_matrix: np.ndarray, sigma_inv: np.ndarray,
                    offset: float, device=None,
                    fast_copies: bool | None = None
                    ) -> IvectorExtractorParams:
    """Load-time precompute of ``proj`` and ``quad_packed`` in float32 on the
    device (~90 GFLOP at C=2048, IV=600).  ``fast_copies`` (default: on a
    CUDA device) also stores their bf16 copies."""
    dev = resolve_device(device)
    m = torch.as_tensor(np.asarray(extractor_matrix, np.float32), device=dev)
    s = torch.as_tensor(np.asarray(sigma_inv, np.float32), device=dev)
    iv = m.shape[2]
    rows, cols = (torch.as_tensor(i, device=dev) for i in np.triu_indices(iv))
    proj = torch.einsum("cdi,cde->cie", m, s)
    # one component group at a time keeps the full (C, IV, IV) tensor
    # (2.95 GB at full size) from being materialized at once
    quad_packed = torch.cat([
        torch.einsum("cie,cej->cij", proj[g:g + 256], m[g:g + 256])[:, rows,
                                                                     cols]
        for g in range(0, m.shape[0], 256)])
    if fast_copies is None:
        fast_copies = dev.type == "cuda"
    bf16 = torch.bfloat16
    return IvectorExtractorParams(
        extractor_matrix=m, sigma_inv=s,
        offset=torch.tensor(float(offset), dtype=torch.float32, device=dev),
        quad_packed=quad_packed, proj=proj,
        quad_packed_bf16=quad_packed.to(bf16) if fast_copies else None,
        proj_bf16=proj.to(bf16) if fast_copies else None)


def _fast_quad(params: IvectorExtractorParams) -> torch.Tensor:
    q = params.quad_packed_bf16
    return q if q is not None else params.quad_packed.to(torch.bfloat16)


def _fast_proj(params: IvectorExtractorParams) -> torch.Tensor:
    p = params.proj_bf16
    return p if p is not None else params.proj.to(torch.bfloat16)


def random_extractor(rng: np.random.Generator, num_gaussians: int = 2048,
                     dim: int = 60, ivector_dim: int = 600,
                     device=None) -> IvectorExtractorParams:
    m = rng.standard_normal((num_gaussians, dim, ivector_dim)) * 0.05
    a = rng.standard_normal((num_gaussians, dim, dim)) * 0.1
    sigma_inv = np.einsum("cij,ckj->cik", a, a) + np.eye(dim)
    return build_extractor(m, sigma_inv, 1.0, device=device)


SPD_SOLVERS = ("cholesky_rt", "cholesky_rt_dinv", "chol_solve")


def _chol_apply(factor: torch.Tensor, v: torch.Tensor,
                dinv_t: torch.Tensor | None = None) -> torch.Tensor:
    """Solve A x = v given A = R^T R (two triangular solves; with the
    factor's dinv_t both are batched matvecs)."""
    kw = {} if dinv_t is None else {"dinv_t": dinv_t, "m": DINV_M}
    y = triangular_solve_vec(factor, v, lower=False, transpose_a=True, **kw)
    return triangular_solve_vec(factor, y, lower=False, **kw)


class _SpdSolve(torch.autograd.Function):
    """x = A^-1 rhs.  The backward (grad_rhs = A^-1 g, grad_A = -outer(
    grad_rhs, x)) needs a second solve against the same matrix.

    "cholesky_rt" / "cholesky_rt_dinv": the forward saves the Cholesky
    FACTOR (and its dinv_t) and the backward is two triangular solves:
    exactly one factorization per forward + backward.  A bf16 A (the fast
    path's bf16 L) is read by the kernel as it is.
    "chol_solve": one fused solve each way; the backward has no factor and
    solves against the saved matrix once more.  A bf16 A is converted to
    float32 first and ``bf16_updates`` does not apply (JAX ivector.py
    _make_spd_solve, kind "fused").
    Either way A's cotangent is cast to A's dtype."""

    @staticmethod
    def forward(ctx, l_mat, rhs, bf16_updates, solver):
        ctx.l_dtype = l_mat.dtype
        ctx.solver = solver
        if solver == "chol_solve":
            x = chol_solve(l_mat.to(torch.float32), rhs)
            ctx.save_for_backward(l_mat, x)
            return x
        if solver == "cholesky_rt_dinv":
            factor, dinv_t = cholesky_rt_dinv(l_mat,
                                              bf16_updates=bf16_updates)
        else:
            factor = cholesky_rt(l_mat, bf16_updates=bf16_updates)
            dinv_t = None
        x = _chol_apply(factor, rhs, dinv_t)
        ctx.save_for_backward(factor, dinv_t, x)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.solver == "chol_solve":
            l_mat, x = ctx.saved_tensors
            u = chol_solve(l_mat.to(torch.float32), g)
        else:
            factor, dinv_t, x = ctx.saved_tensors
            u = _chol_apply(factor, g, dinv_t)
        return (-u[:, :, None] * x[:, None, :]).to(ctx.l_dtype), u, None, None


def spd_solve(l_mat: torch.Tensor, rhs: torch.Tensor,
              bf16_updates: bool = False,
              solver: str = "cholesky_rt") -> torch.Tensor:
    """Batched SPD solve x = A^-1 rhs.  l_mat: (B, N, N) symmetric positive
    definite, float32 or bfloat16; rhs: (B, N).  ``solver`` (SPD_SOLVERS)
    picks the kernel: "cholesky_rt" (factor, then two triangular solves),
    "cholesky_rt_dinv" (factor and inverted diagonal blocks, then two
    block substitutions of batched matvecs) or "chol_solve" (one fused
    solve; ``bf16_updates`` does not apply)."""
    if solver not in SPD_SOLVERS:
        raise ValueError(f"solver {solver!r} not in {SPD_SOLVERS}")
    return _SpdSolve.apply(l_mat, rhs, bf16_updates, solver)


@functools.lru_cache(maxsize=None)
def _sym_indices(iv: int, device: torch.device):
    """(IV*IV,) index of each full-matrix entry into the packed upper
    triangle (np.triu_indices order), the triangle's (rows, cols), and its
    off-diagonal mask, on the device, built once."""
    rows, cols = np.triu_indices(iv)
    idx = np.zeros((iv, iv), np.int64)
    idx[rows, cols] = np.arange(len(rows))
    idx[cols, rows] = np.arange(len(rows))
    return tuple(torch.as_tensor(a, device=device) for a in
                 (idx.ravel(), rows, cols, (rows != cols).astype(np.float32)))


class _SymUnpack(torch.autograd.Function):
    """Packed upper triangle (B, P) -> full symmetric (B, IV, IV).  One
    gather forward; the backward is two gathers (cot[r, c] + cot[c, r] off
    the diagonal) instead of a gather's scatter-add (JAX ivector.py
    _sym_unpack), kept in the primal's dtype."""

    @staticmethod
    def forward(ctx, packed, iv):
        ctx.iv = iv
        idx = _sym_indices(iv, packed.device)[0]
        return packed[:, idx].reshape(-1, iv, iv)

    @staticmethod
    def backward(ctx, cot):
        _, rows, cols, offdiag = _sym_indices(ctx.iv, cot.device)
        up = cot[:, rows, cols]
        lo = cot[:, cols, rows]
        return (up + lo * offdiag).to(cot.dtype), None


def sym_unpack(packed: torch.Tensor, iv: int) -> torch.Tensor:
    return _SymUnpack.apply(packed, iv)


class _QuadContract(torch.autograd.Function):
    """Packed L = zeroth @ quad_packed.  The exact path: float32 both ways
    (JAX ivector.py _quad_contract).  fast: the bf16 copy with f32
    accumulation; out16 also rounds the packed L to bf16 at the output
    (_quad_contract_fast16), else it stays f32 (_quad_contract_fast).  The
    zeroth cotangent is float32; quad_packed gets none."""

    @staticmethod
    def forward(ctx, zeroth, quad, fast, out16):
        ctx.save_for_backward(quad)
        ctx.fast = fast
        if not fast:
            return zeroth @ quad
        dt = fast_dot_dtype(zeroth.device)
        if out16 and dt == torch.bfloat16:
            return zeroth.to(dt) @ quad.to(dt)
        out = dot_f32(zeroth.to(dt), quad.to(dt))
        return out.to(torch.bfloat16) if out16 else out

    @staticmethod
    def backward(ctx, cot):
        (quad,) = ctx.saved_tensors
        if not ctx.fast:
            return cot @ quad.T, None, None, None
        dt = fast_dot_dtype(cot.device)
        return dot_f32(cot.to(dt), quad.to(dt).T), None, None, None


class IvectorTopK(NamedTuple):
    """Extractor tensors sliced to a frozen shared component selection
    (gmm.GmmTopKContext.sel) for one attack run."""
    quad_sel: torch.Tensor  # (K, IV(IV+1)/2) bf16
    proj_sel: torch.Tensor  # (K, IV, D) bf16


@torch.no_grad()
def make_topk_slices(params: IvectorExtractorParams,
                     sel: torch.Tensor) -> IvectorTopK:
    """The (K, .) bf16 extractor slices of a shared selection, once per
    attack run."""
    return IvectorTopK(quad_sel=_fast_quad(params).index_select(0, sel),
                       proj_sel=_fast_proj(params).index_select(0, sel))


def extract_ivectors(params: IvectorExtractorParams, zeroth: torch.Tensor,
                     first: torch.Tensor, fast: FastPath | None = None,
                     topk: IvectorTopK | None = None,
                     spd_solver: str = "cholesky_rt") -> torch.Tensor:
    """zeroth: (B, C), first: (B, C, D) -> ivectors (B, IV).

    Matches reference ivector_extract.py:98-114 (Extractivector), batched.
    ``fast`` (a FastPath; None = exact) uses the bf16 parameter copies, or
    with ``topk`` the slices matching SELECTED-space stats (B, K) /
    (B, K, D).  The factorization reads the (bf16 or f32) L as it is;
    ``spd_solver`` picks the kernel of the solve (``spd_solve``)."""
    if topk is not None and fast is None:
        raise ValueError("topk slices are a fast-path-only knob")
    iv = params.ivector_dim
    if fast is None:
        l_packed = _QuadContract.apply(zeroth, params.quad_packed, False,
                                       False)
        linear = torch.einsum("cid,bcd->bi", params.proj, first)
    else:
        quad, proj = ((topk.quad_sel, topk.proj_sel) if topk is not None
                      else (_fast_quad(params), _fast_proj(params)))
        l_packed = _QuadContract.apply(zeroth, quad, True, fast.ivec_l_bf16)
        dt = fast_dot_dtype(zeroth.device)
        k = proj.shape[0]
        # einsum("cid,bcd->bi") as one (B, K*D) @ (K*D, IV) product
        linear = dot_f32(first.to(dt).reshape(first.shape[0], -1),
                         proj.to(dt).permute(0, 2, 1).reshape(k * proj.shape[2],
                                                              iv))
    eye = torch.eye(iv, dtype=l_packed.dtype, device=l_packed.device)
    l_mat = sym_unpack(l_packed, iv) + eye
    offset = torch.zeros_like(linear[0])
    offset[0] = params.offset
    # L is SPD by construction (I + a sum of PSD terms)
    ivec = spd_solve(l_mat, linear + offset,
                     bf16_updates=fast is not None and fast.chol_bf16_updates,
                     solver=spd_solver)
    return ivec - offset


def length_normalize(vec: torch.Tensor,
                     expected_length: torch.Tensor | float) -> torch.Tensor:
    """vec: (..., D); scales to the expected L2 norm
    (reference ivector_extract.py:116-125)."""
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
    return vec * (expected_length / torch.clamp(norm, min=1e-12))
