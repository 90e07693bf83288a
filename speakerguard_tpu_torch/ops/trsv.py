"""Batched triangular solves with a vector right-hand side.

Counterpart of speakerguard_tpu/ops/trsv.py ``triangular_solve_vec``.  The
JAX version does block substitution to work around the latency of XLA's
vector-RHS triangular_solve on the TPU; it is not a Pallas kernel, and on the
card ``torch.linalg.solve_triangular`` does the same job.  The signature and
orientation flags are kept.
"""

import torch


def triangular_solve_vec(r: torch.Tensor, v: torch.Tensor, lower: bool,
                         transpose_a: bool = False) -> torch.Tensor:
    """Solve op(R) x = v for batched triangular R.

    r: (B, N, N) triangular (upper if not `lower`); v: (B, N).
    op(R) = R^T when transpose_a.  Only R's triangle is read."""
    if transpose_a:
        r, lower = r.mT, not lower
    x = torch.linalg.solve_triangular(r, v[..., None], upper=not lower)
    return x[..., 0]
