"""Batched upper Cholesky factor R (R^T R = A): CUDA kernel + plain version.

Port of the Pallas TPU kernel speakerguard_tpu/ops/pallas_chol.py
``cholesky_rt``.  ``cholesky_rt(a)`` launches the hand-written kernel in
``csrc/chol.cu`` on a CUDA tensor and runs ``cholesky_rt_plain`` on a CPU
tensor; there is no fallback from one to the other.

Both compute the same right-looking blocked sweep with panels of ``NB``
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

NB = 32  # panel rows; the kernel reports its own and _kernel() checks it


def _check(a: torch.Tensor):
    if a.ndim != 3 or a.shape[1] != a.shape[2] or a.shape[1] < 1:
        raise ValueError(f"expected (B, N, N) with N >= 1, got "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {a.dtype}")


def cholesky_rt_plain(a: torch.Tensor,
                      bf16_updates: bool = False) -> torch.Tensor:
    """The kernel's algorithm in PyTorch ops (the CPU path and the card's
    comparison yardstick)."""
    _check(a)
    n = a.shape[-1]
    work = torch.triu(a.to(torch.float32))
    r = torch.zeros_like(work)
    for k0 in range(0, n, NB):
        k1 = min(k0 + NB, n)
        pan = work[:, k0:k1, k0:].clone()      # (B, p, n - k0)
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
            work[:, k1:, k1:] -= torch.triu(p.mT @ p)
    return r


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/chol.cu, built at first use."""
    from speakerguard_tpu_torch.ops._build import load_library
    lib = load_library("chol")
    lib.sg_cholesky_rt_nb.restype = ctypes.c_int
    if lib.sg_cholesky_rt_nb() != NB:
        # the plain version and blocked_residual group the updates by NB
        raise RuntimeError(f"csrc/chol.cu panels {lib.sg_cholesky_rt_nb()} "
                           f"rows, ops/chol.py NB = {NB}")
    fn = lib.sg_cholesky_rt
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _CholeskyRT(KernelWrapper):
    """``cholesky_rt(a, bf16_updates=False) -> R``, counting its calls."""

    name = "cholesky_rt"

    def __call__(self, a: torch.Tensor,
                 bf16_updates: bool = False) -> torch.Tensor:
        _check(a)
        if not self.route(a):
            return cholesky_rt_plain(a, bf16_updates)
        fn = _kernel()
        a = a.contiguous()
        b, n, _ = a.shape
        out = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
        work = torch.empty_like(out)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(a.data_ptr(), int(a.dtype == torch.bfloat16),
                    work.data_ptr(), out.data_ptr(), b, n, int(bf16_updates),
                    stream)
        check_rc(rc, "cholesky_rt")
        self.launches += 1
        return out


cholesky_rt = _CholeskyRT()
