"""FeCo — feature-level compression defense (the reference authors' own).

Port of speakerguard_tpu/defenses/feature_level.py (reference
defense/feature_level.py): k-means compression of the acoustic-feature
frames to a `param` ratio of the original count (ops/kmeans.py), the
gradient flowing through the segment means of the live features.

Randomness (see defenses/time_domain.py): k-means takes its K initial
frames per row as the first K of a frame order from ``draw`` (kind
``"kmeans_init"``, shape (B, T); with ``draw`` None from a generator on
seed 0, as the JAX package falls back to ``PRNGKey(0)``); warped k-means
draws its host seed (kind ``"wk_seed"``; 0 when ``draw`` is None).
"""

import torch

from speakerguard_tpu_torch.defenses.time_domain import generator_draw
from speakerguard_tpu_torch.ops.kmeans import (kmeans_compress_batch,
                                               warped_kmeans_compress)


def FEATURE_COMPRESSION(feat, method: str = "kmeans", param: float = 0.5,
                        other_param: str = "L2", draw=None):
    """feat: (B, T, F) -> (B, int(T*param), F)."""
    if method == "kmeans":
        if other_param not in ("L2", "cos"):
            raise ValueError(f"kmeans distance {other_param!r}: L2 or cos")
        if draw is None:
            draw = generator_draw(
                torch.Generator(device=feat.device).manual_seed(0))
        b, t, _ = feat.shape
        order = draw("kmeans_init", (b, t))
        return kmeans_compress_batch(
            feat, param, distance=other_param,
            init_idx=order[:, :max(int(t * param), 1)])
    if method == "warped_kmeans":
        if other_param not in ("ts", "random"):
            raise ValueError(f"warped_kmeans init {other_param!r}: ts or "
                             "random")
        seed = 0 if draw is None else int(draw("wk_seed", ()))
        return warped_kmeans_compress(feat, param, init=other_param,
                                      seed=seed)
    raise NotImplementedError(
        "FEATURE_COMPRESSION supports kmeans and warped_kmeans")


def FeCo(feat, method: str = "kmeans", param: float = 0.5,
         other_param: str = "L2", draw=None):
    return FEATURE_COMPRESSION(feat, method, param, other_param, draw=draw)
