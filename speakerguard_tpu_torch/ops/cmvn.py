"""Sliding-window cepstral mean normalization (CMN), batched.

Port of speakerguard_tpu/ops/cmvn.py.  The reference walks frames one by one
(reference model/iv_plda.py:296-377); the window boundaries depend only on
(t, num_frames), so the whole thing is a prefix sum and two gathers:

    mean_t = (cumsum[end_t] - cumsum[start_t]) / (end_t - start_t)

Parameters pinned to the reference: center=True, cmn_window=300,
normalize_variance=False.
"""

import functools

import numpy as np
import torch


def window_bounds(t: int, cmn_window: int = 300, center: bool = True):
    """Per-frame [start, end) window bounds (Kaldi sliding CMN)."""
    starts = np.empty(t, dtype=np.int64)
    ends = np.empty(t, dtype=np.int64)
    for i in range(t):
        if center:
            ws = i - cmn_window // 2
            we = ws + cmn_window
        else:
            ws, we = 0, i + 1
        if ws < 0:
            we -= ws
            ws = 0
        if we > t:
            ws -= (we - t)
            we = t
            if ws < 0:
                ws = 0
        starts[i], ends[i] = ws, we
    return starts, ends


@functools.lru_cache(maxsize=None)
def _window_tensors(t: int, cmn_window: int, center: bool,
                    device: torch.device):
    """(starts, ends, counts) on the device, built once per shape, or None
    when every window covers the whole utterance."""
    starts, ends = window_bounds(t, cmn_window, center)
    if (starts == 0).all() and (ends == t).all():
        return None
    counts = (ends - starts).astype(np.float32)[None, :, None]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (starts, ends, counts))


def sliding_cmvn(feat: torch.Tensor, cmn_window: int = 300,
                 center: bool = True) -> torch.Tensor:
    """feat: (B, T, F) -> mean-normalized (B, T, F)."""
    b, t, f = feat.shape
    bounds = _window_tensors(t, cmn_window, center, feat.device)
    if bounds is None:
        # every window covers the whole utterance: global mean subtract
        return feat - torch.mean(feat, dim=1, keepdim=True)
    starts, ends, counts = bounds
    csum = torch.cumsum(feat, dim=1)
    csum = torch.cat([feat.new_zeros((b, 1, f)), csum], dim=1)
    return feat - (csum[:, ends] - csum[:, starts]) / counts
