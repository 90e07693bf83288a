"""The Cholesky family: CUDA kernels + plain versions.

Ports of the Pallas TPU kernels in speakerguard_tpu/ops/pallas_chol.py:

  ``cholesky_rt(a)``       the batched upper Cholesky factor R, R^T R = A;
  ``cholesky_rt_dinv(a)``  R and ``dinv_t``, the inverse-transposes of R's
                           128 x 128 diagonal blocks (identity on the pad
                           diagonal past N), so that both triangular solves
                           of an SPD solve become batched matvecs
                           (ops/trsv.py ``dinv_t=``);
  ``chol_solve(a, v)``     x = A^-1 v in one call: the sweep carries v as one
                           more column (it leaves y = R^-T v), then a blocked
                           back-substitution solves R x = y.

Each wrapper launches the hand-written kernel in ``csrc/chol.cu`` on a CUDA
tensor and runs its ``*_plain`` version on a CPU tensor; there is no fallback
from one to the other.  On the card the whole sweep is one launch, one block
per matrix, with the 32-row panel stripe in the block's shared memory, so
the kernels take N <= ``MAX_N`` (1780): above it a CUDA call raises a
ValueError before any launch (the plain versions have no limit).

All three compute the same right-looking blocked sweep with panels of ``NB``
rows: NB sequential pivot steps on the panel rows in float32, then one
trailing update work[k1:, k1:] -= P^T P (upper triangle) with
P = R[k0:k1, k1:].  ``bf16_updates`` rounds the trailing-update operands to
bfloat16 and accumulates in float32; the pivot steps stay float32.  Only the
upper triangle and the diagonal of ``a`` are read, and R's strictly-lower
triangle is exactly 0.

``blocked_residual`` checks a factor against that algorithm exactly: it
rebuilds A from R with the same panel grouping and the same bf16 rounding,
so its error is f32 round-off whatever R's own rounding decisions were.
"""

import ctypes
import functools

import torch

from speakerguard_tpu_torch.ops._build import KernelWrapper, check_rc

NB = 32      # panel rows; the kernel reports its own and _lib() checks it
DINV_M = 128  # edge of the diagonal blocks that cholesky_rt_dinv inverts
# the largest N of the kernels: 128 LD + 4480 bytes of shared memory, LD = N
# rounded up to 4, within 232,448 (csrc/chol.cu; _lib() checks it)
MAX_N = 1780


def _check(a: torch.Tensor):
    if a.ndim != 3 or a.shape[1] != a.shape[2] or a.shape[1] < 1:
        raise ValueError(f"expected (B, N, N) with N >= 1, got "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {a.dtype}")


def _check_solve(a: torch.Tensor, v: torch.Tensor):
    _check(a)
    if a.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"chol_solve takes float32 (convert a bf16 A first), "
                        f"got {a.dtype} and {v.dtype}")
    if tuple(v.shape) != tuple(a.shape[:2]):
        raise ValueError(f"expected v of shape {tuple(a.shape[:2])}, got "
                         f"{tuple(v.shape)}")
    if v.device != a.device:
        raise ValueError(f"a on {a.device}, v on {v.device}")


def _sweep(a: torch.Tensor, v: torch.Tensor | None = None,
           bf16_updates: bool = False):
    """The blocked sweep in PyTorch ops.  Returns R, and with ``v`` also
    y = R^-T v: v rides every row operation as one more column."""
    n = a.shape[-1]
    work = torch.triu(a.to(torch.float32))
    if v is not None:
        work = torch.cat([work, v[..., None]], dim=-1)
    r = torch.zeros_like(work)
    for k0 in range(0, n, NB):
        k1 = min(k0 + NB, n)
        pan = work[:, k0:k1, k0:].clone()      # (B, p, width - k0)
        for j in range(k1 - k0):
            piv = torch.sqrt(pan[:, j, j])
            inv = 1.0 / piv
            pan[:, j, j + 1:] *= inv[:, None]
            pan[:, j, j] = piv
            # rank-1 update of the panel rows below j, columns > j (their
            # strictly-lower part is never read; the triu below clears it)
            pan[:, j + 1:, j + 1:] -= (pan[:, j, j + 1:k1 - k0, None]
                                       * pan[:, j, None, j + 1:])
        r[:, k0:k1, k0:] = torch.triu(pan)
        if k1 < n:
            p = r[:, k0:k1, k1:]
            if bf16_updates:
                p = p.to(torch.bfloat16).to(torch.float32)
            work[:, k1:, k1:] -= torch.triu(p[..., :n - k1].mT @ p)
    if v is None:
        return r
    return r[..., :n], r[..., n]


def cholesky_rt_plain(a: torch.Tensor,
                      bf16_updates: bool = False) -> torch.Tensor:
    """The kernel's algorithm in PyTorch ops (the CPU path and the card's
    comparison yardstick)."""
    _check(a)
    return _sweep(a, bf16_updates=bf16_updates)


def diag_block_inverses_t(r: torch.Tensor, m: int = DINV_M) -> torch.Tensor:
    """(B, N, N) upper triangular R -> (B, K, m, m), K = ceil(N / m):
    [:, i] = inv(D_i)^T for the i-th m x m diagonal block D_i of R padded
    with identity past N.  Row-by-row back-substitution of D X = I, every
    column at once, in float32 (the inversion launch of cholesky_rt_dinv
    computes each column the same way)."""
    b, n = r.shape[0], r.shape[-1]
    k = -(-n // m)
    eye = torch.eye(m, dtype=torch.float32, device=r.device)
    d = eye.repeat(b, k, 1, 1)
    for i in range(k):
        s = min(m, n - i * m)
        d[:, i, :s, :s] = torch.triu(r[:, i * m:i * m + s, i * m:i * m + s])
    x = torch.zeros_like(d)
    for i in range(m - 1, -1, -1):
        acc = (d[:, :, i, None, i + 1:] @ x[:, :, i + 1:, :])[:, :, 0]
        x[:, :, i, :] = (eye[i] - acc) / d[:, :, i, i, None]
    return x.mT


def cholesky_rt_dinv_plain(a: torch.Tensor, bf16_updates: bool = False):
    """(R, dinv_t): R is ``cholesky_rt_plain(a, bf16_updates)`` bit for
    bit, dinv_t its diagonal blocks' inverse-transposes."""
    r = cholesky_rt_plain(a, bf16_updates)
    return r, diag_block_inverses_t(r)


def _back_substitute(r: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve R x = y by NB-row blocks from the bottom: the block's rows take
    the solved x below them in one matvec, then its NB x NB triangle is
    solved row by row upward."""
    n = r.shape[-1]
    x = torch.zeros_like(y)
    for k0 in reversed(range(0, n, NB)):
        k1 = min(k0 + NB, n)
        val = y[:, k0:k1] - (r[:, k0:k1, k1:] @ x[:, k1:, None])[..., 0]
        d = r[:, k0:k1, k0:k1]
        for j in range(k1 - k0 - 1, -1, -1):
            xj = val[:, j] / d[:, j, j]
            val[:, :j] -= d[:, :j, j] * xj[:, None]
            val[:, j] = xj
        x[:, k0:k1] = val
    return x


def chol_solve_plain(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x = A^-1 v with the kernel's algorithm in PyTorch ops, float32."""
    _check_solve(a, v)
    r, y = _sweep(a, v)
    return _back_substitute(r, y)


def blocked_residual(a: torch.Tensor, r: torch.Tensor,
                     bf16_updates: bool = False) -> float:
    """max |upper(A - A')| / max |A| in float64, where A' is rebuilt from R
    as the blocked sweep built it: the rows of each panel [k0, k1) take the
    earlier panels' updates from bf16-rounded R entries when
    ``bf16_updates`` (plain f32 R otherwise) and their own pivot steps from
    f32 R.  A correct factor gives f32 round-off (~1e-6); a skipped or
    mis-rounded trailing update gives far more."""
    n = a.shape[-1]
    r64 = r.to(torch.float64)
    rb = r.to(torch.bfloat16).to(torch.float64) if bf16_updates else r64
    rebuilt = torch.zeros_like(r64)
    for k0 in range(0, n, NB):
        k1 = min(k0 + NB, n)
        rebuilt[:, k0:k1] = (rb[:, :k0, k0:k1].mT @ rb[:, :k0]
                             + r64[:, k0:k1, k0:k1].mT @ r64[:, k0:k1])
    a64 = a.to(torch.float64)
    return float(torch.triu(rebuilt - a64).abs().max() / a64.abs().max())


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# The argument types of csrc/chol.cu's C entry points, in order (a CPU test
# holds them to the source's extern "C" declarations); each returns an int.
ARGTYPES = {
    # a, a_is_bf16, out, batch, n, bf16_updates, stream
    "sg_cholesky_rt": [_PTR, _INT, _PTR, _INT, _INT, _INT, _PTR],
    # a, a_is_bf16, out, dinv_t, batch, n, bf16_updates, stream
    "sg_cholesky_rt_dinv": [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    # a, v, out, y, x, batch, n, stream
    "sg_chol_solve": [_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR],
    "sg_cholesky_rt_nb": [],
    "sg_cholesky_rt_max_n": [],
}


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of csrc/chol.cu, built at first use."""
    from speakerguard_tpu_torch.ops._build import load_library
    lib = load_library("chol")
    for name, args in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    if lib.sg_cholesky_rt_nb() != NB:
        # the plain versions and blocked_residual group the updates by NB
        raise RuntimeError(f"csrc/chol.cu panels {lib.sg_cholesky_rt_nb()} "
                           f"rows, ops/chol.py NB = {NB}")
    if lib.sg_cholesky_rt_max_n() != MAX_N:
        raise RuntimeError(f"csrc/chol.cu takes N <= "
                           f"{lib.sg_cholesky_rt_max_n()}, ops/chol.py "
                           f"MAX_N = {MAX_N}")
    return lib


def check_kernel_n(n: int):
    """Raise unless the kernels take N: the sweep keeps the NB x N panel
    stripe in one block's shared memory, so N <= MAX_N."""
    if n > MAX_N:
        raise ValueError(f"N = {n}: the CUDA Cholesky kernels take N <= "
                         f"{MAX_N} (the {NB}-row panel stripe and the "
                         f"diagonal block in 227 KB of shared memory)")


def _launch(fn, t: torch.Tensor, *args) -> int:
    """Call a C entry point with ``args`` and the current stream of
    ``t``'s device, that device current."""
    with torch.cuda.device(t.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


class _CholeskyRT(KernelWrapper):
    """``cholesky_rt(a, bf16_updates=False) -> R``, counting its calls."""

    name = "cholesky_rt"

    def __call__(self, a: torch.Tensor,
                 bf16_updates: bool = False) -> torch.Tensor:
        _check(a)
        if not self.route(a):
            return cholesky_rt_plain(a, bf16_updates)
        check_kernel_n(a.shape[-1])
        a = a.contiguous()
        b, n, _ = a.shape
        out = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
        rc = _launch(_lib().sg_cholesky_rt, a, a.data_ptr(),
                     int(a.dtype == torch.bfloat16), out.data_ptr(), b, n,
                     int(bf16_updates))
        check_rc(rc, self.name)
        self.launches += 1
        return out


class _CholeskyRTDinv(KernelWrapper):
    """``cholesky_rt_dinv(a, bf16_updates=False) -> (R, dinv_t)``: R as
    ``cholesky_rt`` computes it, bit for bit, and dinv_t (B, K, 128, 128)
    float32, K = ceil(N / 128); counting its calls."""

    name = "cholesky_rt_dinv"

    def __call__(self, a: torch.Tensor, bf16_updates: bool = False):
        _check(a)
        if not self.route(a):
            return cholesky_rt_dinv_plain(a, bf16_updates)
        check_kernel_n(a.shape[-1])
        a = a.contiguous()
        b, n, _ = a.shape
        k = -(-n // DINV_M)
        out = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
        dinv_t = torch.empty((b, k, DINV_M, DINV_M), dtype=torch.float32,
                             device=a.device)
        rc = _launch(_lib().sg_cholesky_rt_dinv, a, a.data_ptr(),
                     int(a.dtype == torch.bfloat16), out.data_ptr(),
                     dinv_t.data_ptr(), b, n, int(bf16_updates))
        check_rc(rc, self.name)
        self.launches += 1
        return out, dinv_t


class _CholSolve(KernelWrapper):
    """``chol_solve(a, v) -> x = a^-1 v``, float32 (B, N, N) and (B, N);
    counting its calls."""

    name = "chol_solve"

    def __call__(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        _check_solve(a, v)
        if not self.route(a):
            return chol_solve_plain(a, v)
        check_kernel_n(a.shape[-1])
        a, v = a.contiguous(), v.contiguous()
        b, n, _ = a.shape
        out = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
        y, x = torch.empty_like(v), torch.empty_like(v)
        rc = _launch(_lib().sg_chol_solve, a, a.data_ptr(), v.data_ptr(),
                     out.data_ptr(), y.data_ptr(), x.data_ptr(), b, n)
        check_rc(rc, self.name)
        self.launches += 1
        return x


cholesky_rt = _CholeskyRT()
cholesky_rt_dinv = _CholeskyRTDinv()
chol_solve = _CholSolve()
