"""Kaldi add-deltas, batched (port of speakerguard_tpu/ops/delta.py).

Order-2 deltas with window 3 (reference model/iv_plda.py:248-293): the delta
scales are computed once on the host and the features are combined as
edge-padded shifts with a weighted sum.

Output: concat([feat, delta1, delta2], dim=-1)  => F -> F*(order+1).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def delta_scales(window: int = 3, order: int = 2) -> tuple:
    """Kaldi DeltaFeatures scales: scales[0]=[1]; scales[i] = conv of
    scales[i-1] with the length-(2*window+1) regression kernel
    [-w..w]/sum(j^2)."""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(1, order + 1):
        prev = scales[-1]
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window, dtype=np.float64)
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        scales.append(cur / normalizer)
    return tuple(s.astype(np.float32) for s in scales)


def add_delta(feat: torch.Tensor, window: int = 3,
              order: int = 2) -> torch.Tensor:
    """feat: (B, T, F) -> (B, T, F*(order+1)).  Edges replicate (index
    clamp), matching the reference's clamped-offset gather."""
    t = feat.shape[1]
    outs = []
    for s in delta_scales(window, order):
        max_offset = (len(s) - 1) // 2
        if max_offset == 0:
            outs.append(feat * float(s[0]))
            continue
        # replicate-pad the time axis: (B, T, F) -> (B, T + 2*off, F)
        fp = F.pad(feat.transpose(1, 2), (max_offset, max_offset),
                   mode="replicate").transpose(1, 2)
        acc = None
        for k, w in enumerate(s):
            if w == 0.0:
                continue
            term = float(w) * fp[:, k:k + t]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1)
