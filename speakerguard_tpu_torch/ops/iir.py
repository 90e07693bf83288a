"""IIR filtering as a truncated-impulse-response FIR convolution.

Port of speakerguard_tpu/ops/iir.py.  The reference applies Butterworth
LPF/BPF through a per-sample loop on the CPU (reference
defense/frequency_domain.py:33-112).  Here the stable filter's impulse
response is computed on the host with scipy and truncated once its tail is
below a tolerance, then applied as one causal ``conv1d`` (equal to lfilter
up to the discarded sub-tolerance tail).  ``lfilter_scan``, the exact
recurrence as a plain loop, is kept for the tests.
"""

import functools

import numpy as np
from scipy import signal as ssig
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _truncated_impulse_response(b: tuple, a: tuple, tol: float = 1e-7,
                                max_len: int = 1 << 16) -> np.ndarray:
    """Impulse response of lfilter(b, a), truncated once |tail| < tol."""
    n = 1024
    while n <= max_len:
        imp = np.zeros(n)
        imp[0] = 1.0
        h = ssig.lfilter(np.asarray(b), np.asarray(a), imp)
        tail = np.max(np.abs(h[-(n // 4):]))
        if tail < tol or n == max_len:
            # cut where the remaining tail is < tol
            mags = np.abs(h[::-1])
            keep = n - np.argmax(np.maximum.accumulate(mags) >= tol)
            return h[:max(keep, len(b))].astype(np.float32)
        n *= 2
    raise RuntimeError("filter impulse response does not decay")


def fir_from_iir(b, a, tol: float = 1e-7) -> np.ndarray:
    return _truncated_impulse_response(tuple(np.asarray(b, np.float64)),
                                       tuple(np.asarray(a, np.float64)), tol)


def apply_fir(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Causal convolution matching scipy.signal.lfilter semantics
    (``conv1d`` is a cross-correlation, so the taps are flipped).
    x: (B, L) -> (B, L)."""
    k = len(h)
    w = torch.as_tensor(np.ascontiguousarray(h[::-1]),
                        device=x.device)[None, None, :]
    return F.conv1d(F.pad(x, (k - 1, 0))[:, None, :], w)[:, 0, :]


def lfilter_scan(x: torch.Tensor, b, a) -> torch.Tensor:
    """Exact IIR (direct form II transposed) as a loop over samples, in
    float32 as the JAX package's ``lax.scan`` runs it; for tests.
    x: (B, L)."""
    b = torch.as_tensor(np.asarray(b), dtype=torch.float32)
    a = torch.as_tensor(np.asarray(a), dtype=torch.float32)
    b, a = b / a[0], a / a[0]
    order = max(len(b), len(a))
    bb = F.pad(b, (0, order - len(b)))
    aa = F.pad(a, (0, order - len(a)))
    state = torch.zeros(x.shape[0], order - 1, dtype=x.dtype)
    ys = []
    for xt in x.T:
        yt = bb[0] * xt + state[:, 0]
        state = (F.pad(state[:, 1:], (0, 1)) + bb[1:] * xt[:, None]
                 - aa[1:] * yt[:, None])
        ys.append(yt)
    return torch.stack(ys, dim=1)
