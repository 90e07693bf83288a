"""Singular-spectrum analysis (SSA) for the Kenansville ssa attack.

Port of speakerguard_tpu/ops/ssa.py (reference attack/ssa_core.py): the
Hankel trajectory matrix, its SVD, and the reconstruction from a leading
subset of components by averaging along the anti-diagonals.

``ssa``, ``inv_ssa`` and ``ssa_compress`` are the float64 numpy oracle, a
copy of the JAX package's.  ``ssa_device`` and ``inv_ssa_masked`` are the
device path, batched over B as the JAX package vmaps it: the trajectory is
an ``unfold`` view, the SVD ``torch.linalg.svd`` (a library call, as the
JAX package leaves it to XLA), the components are selected by a mask per
lane, so one call serves every lane's own ``keep``, and the anti-diagonal
sums run over a skewed strided view of the reconstruction: a plain sum over
the window axis, in a fixed order, with no scatter.
"""

import numpy as np
import torch


def ssa(x: np.ndarray, window: int):
    """x: (N,) -> (pc (window, K), s (window,), v (K, window))
    with K = N - window + 1; pc = U * s (principal components)."""
    x = np.asarray(x, np.float64).ravel()
    n = len(x)
    k = n - window + 1
    idx = np.arange(window)[:, None] + np.arange(k)[None, :]
    traj = x[idx]                                   # (window, K)
    u, s, vt = np.linalg.svd(traj, full_matrices=False)
    pc = u * s[None, :]
    return pc, s, vt.T


def inv_ssa(pc: np.ndarray, v: np.ndarray, indices) -> np.ndarray:
    """Reconstruct from selected components by diagonal averaging."""
    window, _ = pc.shape
    k = v.shape[0]
    n = window + k - 1
    traj = pc[:, indices] @ v[:, indices].T          # (window, K)
    out = np.zeros(n)
    counts = np.zeros(n)
    for i in range(window):
        out[i:i + k] += traj[i]
        counts[i:i + k] += 1.0
    return out / counts


def ssa_compress(x: np.ndarray, keep: int, window: int) -> np.ndarray:
    pc, s, v = ssa(x, window)
    return inv_ssa(pc, v, np.arange(keep))


# ---------------------------------------------------------------------------
# the device path
# ---------------------------------------------------------------------------

def trajectory(x: torch.Tensor, window: int) -> torch.Tensor:
    """x: (B, N) -> the Hankel trajectory matrices (B, window, K), a view:
    [b, i, j] = x[b, i + j]."""
    k = x.shape[-1] - window + 1
    return x.unfold(-1, k, 1)


SVD_DRIVER = "gesvda"


def ssa_device(x: torch.Tensor, window: int, driver=SVD_DRIVER):
    """x: (B, N) float32 -> (pc (B, window, window), s (B, window),
    v (B, K, window)), pc = U * s.  ``driver`` is torch.linalg.svd's
    cuSOLVER routine for a CUDA ``x`` (None lets torch choose); the CPU
    has LAPACK's alone, and ignores it.  The default, gesvda, was the
    fastest of torch's drivers on an H100 at 3 s (2400 x 45,601) that
    holds the full reconstruction within 1e-4 of max |x|; torch's own
    choice there (gesvdj) errs ~9e-4 (PERF.md; tools/ssa_svd_drivers.py
    measures each driver)."""
    traj = trajectory(x, window)
    if x.device.type != "cuda":
        driver = None
    u, s, vh = torch.linalg.svd(traj, full_matrices=False, driver=driver)
    return u * s[..., None, :], s, vh.mT


def anti_diagonal_mean(traj: torch.Tensor) -> torch.Tensor:
    """(B, W, K) -> (B, W + K - 1): out[n] = the mean of traj[i, n - i].
    Each row padded with W zeros is laid out with a row stride of
    K + W; the view of stride K + W - 1 over it puts traj[i, n - i] in
    [i, n] (and a pad zero where n - i is out of range), so the sums are
    one reduction over i.  The counts are min(n + 1, W, K, N - n)."""
    b, w, k = traj.shape
    n = w + k - 1
    padded = torch.nn.functional.pad(traj, (0, w)).contiguous()
    skew = padded.as_strided((b, w, n), (w * (k + w), k + w - 1, 1))
    pos = torch.arange(n, device=traj.device)
    counts = torch.minimum(torch.minimum(pos + 1, n - pos),
                           torch.tensor(min(w, k), device=traj.device))
    return skew.sum(dim=1) / counts.to(traj.dtype)


def inv_ssa_masked(pc: torch.Tensor, v: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
    """Reconstruct each lane from its first ``keep[b]`` components:
    pc (B, W, W), v (B, K, W), keep (B,) -> (B, W + K - 1)."""
    ncomp = pc.shape[-1]
    mask = (torch.arange(ncomp, device=pc.device)[None, :]
            < keep[:, None]).to(pc.dtype)
    traj = (pc * mask[:, None, :]) @ v.mT                  # (B, W, K)
    return anti_diagonal_mean(traj)
