"""Batched triangular solves with a vector right-hand side.

Counterpart of speakerguard_tpu/ops/trsv.py ``triangular_solve_vec``.

Without ``dinv_t``: ``torch.linalg.solve_triangular``.  The JAX version's
block substitution with an XLA inversion of the diagonal blocks works around
the latency of XLA's vector-RHS triangular_solve on the TPU; on the card the
library solve does the same job.

With ``dinv_t`` (the pre-inverted, transposed m x m diagonal blocks that
ops/chol.py ``cholesky_rt_dinv`` emits, m = 128): block substitution as the
JAX package does it, all batched matvecs.  Block i takes the solved blocks
in one coupling matvec against op(R)'s rows of block i, then its diagonal
apply is a matvec with dinv_t[:, i].  The last block may be ragged: the
inverse of a block padded with identity has the inverse of the unpadded
block in its top-left corner, so R is never padded.
"""

import torch


def triangular_solve_vec(r: torch.Tensor, v: torch.Tensor, lower: bool,
                         transpose_a: bool = False, m: int = 128,
                         dinv_t: torch.Tensor | None = None) -> torch.Tensor:
    """Solve op(R) x = v for batched triangular R.

    r: (B, N, N) triangular (upper if not `lower`); v: (B, N).
    op(R) = R^T when transpose_a.  Only R's triangle is read.
    dinv_t: optional (B, ceil(N/m), m, m), dinv_t[:, i] = inv(D_i)^T for
    the i-th m x m diagonal block D_i of the STORED factor."""
    if dinv_t is None:
        if transpose_a:
            r, lower = r.mT, not lower
        x = torch.linalg.solve_triangular(r, v[..., None], upper=not lower)
        return x[..., 0]

    b, n = r.shape[0], r.shape[-1]
    k = -(-n // m)
    if tuple(dinv_t.shape) != (b, k, m, m):
        raise ValueError(f"dinv_t {tuple(dinv_t.shape)}, expected "
                         f"{(b, k, m, m)}")
    # lower-triangular op(R) substitutes forward (i ascending), upper
    # backward
    forward = lower != transpose_a
    xs = [None] * k
    for i in (range(k) if forward else reversed(range(k))):
        lo, hi = i * m, min((i + 1) * m, n)
        rhs = v[:, lo:hi]
        done = (0, lo) if forward else (hi, n)
        if done[1] > done[0]:
            x_done = torch.cat([xs[j] for j in (range(i) if forward
                                                else range(i + 1, k))], 1)
            # op(R)[block i, solved blocks] @ x_solved
            if transpose_a:
                blk = r[:, done[0]:done[1], lo:hi].mT
            else:
                blk = r[:, lo:hi, done[0]:done[1]]
            rhs = rhs - (blk @ x_done[..., None])[..., 0]
        # op(inv(D_i)) = dinv_t^T (plain) or dinv_t (transposed)
        dinv = dinv_t[:, i, :hi - lo, :hi - lo]
        if not transpose_a:
            dinv = dinv.mT
        xs[i] = (dinv @ rhs[..., None])[..., 0]
    return torch.cat(xs, 1)
