"""i-vector extractor (total-variability T-matrix), batched.

Port of the exact path of speakerguard_tpu/models/ivector.py (reference
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
(ops/chol.py ``cholesky_rt``) and differentiates by the implicit function
theorem, reusing the forward's factor in the backward.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.ops.chol import cholesky_rt
from speakerguard_tpu_torch.ops.trsv import triangular_solve_vec


class IvectorExtractorParams(NamedTuple):
    extractor_matrix: torch.Tensor  # (C, D, IV)   Kaldi "M"
    sigma_inv: torch.Tensor         # (C, D, D)
    offset: torch.Tensor            # scalar prior offset
    quad_packed: torch.Tensor       # (C, IV(IV+1)/2) upper-tri of T^T S^-1 T
    proj: torch.Tensor              # (C, IV, D)

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
                    offset: float, device=None) -> IvectorExtractorParams:
    """Load-time precompute of ``proj`` and ``quad_packed`` in float32 on the
    device (~90 GFLOP at C=2048, IV=600)."""
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
    return IvectorExtractorParams(
        extractor_matrix=m, sigma_inv=s,
        offset=torch.tensor(float(offset), dtype=torch.float32, device=dev),
        quad_packed=quad_packed, proj=proj)


def random_extractor(rng: np.random.Generator, num_gaussians: int = 2048,
                     dim: int = 60, ivector_dim: int = 600,
                     device=None) -> IvectorExtractorParams:
    m = rng.standard_normal((num_gaussians, dim, ivector_dim)) * 0.05
    a = rng.standard_normal((num_gaussians, dim, dim)) * 0.1
    sigma_inv = np.einsum("cij,ckj->cik", a, a) + np.eye(dim)
    return build_extractor(m, sigma_inv, 1.0, device=device)


def _chol_apply(factor: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solve A x = v given A = R^T R (two triangular solves)."""
    y = triangular_solve_vec(factor, v, lower=False, transpose_a=True)
    return triangular_solve_vec(factor, y, lower=False)


class _SpdSolve(torch.autograd.Function):
    """x = A^-1 rhs.  The backward (grad_rhs = A^-1 g, grad_A = -outer(
    grad_rhs, x)) needs a second solve against the same matrix, so the
    forward saves the Cholesky FACTOR and the backward is two triangular
    solves: exactly one factorization per forward + backward."""

    @staticmethod
    def forward(ctx, l_mat, rhs):
        factor = cholesky_rt(l_mat)
        x = _chol_apply(factor, rhs)
        ctx.save_for_backward(factor, x)
        return x

    @staticmethod
    def backward(ctx, g):
        factor, x = ctx.saved_tensors
        u = _chol_apply(factor, g)
        return -u[:, :, None] * x[:, None, :], u


def spd_solve(l_mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve x = A^-1 rhs via Cholesky.  l_mat: (B, N, N)
    symmetric positive definite; rhs: (B, N)."""
    return _SpdSolve.apply(l_mat, rhs)


@functools.lru_cache(maxsize=None)
def _sym_index(iv: int, device: torch.device) -> torch.Tensor:
    """Flat (IV*IV,) index of each full-matrix entry into the packed upper
    triangle (np.triu_indices order), on the device, built once."""
    rows, cols = np.triu_indices(iv)
    idx = np.zeros((iv, iv), np.int64)
    idx[rows, cols] = np.arange(len(rows))
    idx[cols, rows] = np.arange(len(rows))
    return torch.as_tensor(idx.ravel(), device=device)


def sym_unpack(packed: torch.Tensor, iv: int) -> torch.Tensor:
    """Packed upper triangle (B, P) -> full symmetric (B, IV, IV)."""
    return packed[:, _sym_index(iv, packed.device)].reshape(-1, iv, iv)


def extract_ivectors(params: IvectorExtractorParams, zeroth: torch.Tensor,
                     first: torch.Tensor) -> torch.Tensor:
    """zeroth: (B, C), first: (B, C, D) -> ivectors (B, IV).

    Matches reference ivector_extract.py:98-114 (Extractivector), batched."""
    iv = params.ivector_dim
    l_packed = zeroth @ params.quad_packed
    linear = torch.einsum("cid,bcd->bi", params.proj, first)
    eye = torch.eye(iv, dtype=l_packed.dtype, device=l_packed.device)
    l_mat = sym_unpack(l_packed, iv) + eye
    offset = torch.zeros_like(linear[0])
    offset[0] = params.offset
    # L is SPD by construction (I + a sum of PSD terms)
    ivec = spd_solve(l_mat, linear + offset)
    return ivec - offset


def length_normalize(vec: torch.Tensor,
                     expected_length: torch.Tensor | float) -> torch.Tensor:
    """vec: (..., D); scales to the expected L2 norm
    (reference ivector_extract.py:116-125)."""
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
    return vec * (expected_length / torch.clamp(norm, min=1e-12))
