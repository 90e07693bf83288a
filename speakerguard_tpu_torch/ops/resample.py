"""Polyphase windowed-sinc resampling (torchaudio-compatible), batched.

Port of speakerguard_tpu/ops/resample.py, used by the DS (down-up
resampling) defense (reference defense/frequency_domain.py:8-31).  The
polyphase kernel bank is a numpy constant built once per frequency pair;
the resample itself is one strided ``conv1d`` with ``new`` output channels
(the polyphase branches), then the interleave and the trim.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _sinc_kernels(orig_freq: int, new_freq: int,
                  lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """Kernel bank (new_freq, K) and half-width, for gcd-reduced freqs."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :]
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq
         + idx / orig_freq) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2.0) ** 2
    t = t * math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """x: (B, L) -> (B, ceil(L * new/orig))."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    if orig == new:
        return x
    kernels, width = _sinc_kernels(orig, new)
    b, length = x.shape
    target_len = -(-length * new // orig)  # ceil
    xp = F.pad(x, (width, width + orig))[:, None, :]
    w = torch.as_tensor(kernels, device=x.device)[:, None, :]
    y = F.conv1d(xp, w, stride=orig)                      # (B, new, F)
    y = y.transpose(1, 2).reshape(b, -1)                  # interleave
    return y[:, :target_len]
