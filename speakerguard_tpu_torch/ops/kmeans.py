"""Batched Lloyd k-means for the FeCo defense, on the device.

Port of speakerguard_tpu/ops/kmeans.py (reference
defense/feature_level.py:168-217): a fixed 20-iteration Lloyd loop on the
detached features, batched over B with ``bmm`` (the assignment is an argmin
over a (B, T, K) distance matrix, the centre update a one-hot segment mean),
then the reference's "differentiable compression" trick: the cluster means
are recomputed from the live features with the final assignment held
constant.  The loop has no convergence test, so it never reads the device
from the host.

Also warped k-means (contiguous segments, TS or random boundary init): the
boundary search is sequential, so it runs on the host in numpy, as the
reference's does; the segment-mean recompute stays on the device for
gradients.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def _distances(feat, centers, distance: str):
    """feat (B, T, F), centers (B, K, F) -> (B, T, K), in the JAX
    package's order of operations."""
    if distance == "cos":
        f = feat / torch.clamp(torch.linalg.norm(feat, dim=-1, keepdim=True),
                               min=1e-12)
        c = centers / torch.clamp(
            torch.linalg.norm(centers, dim=-1, keepdim=True), min=1e-12)
        return 1.0 - f @ c.transpose(1, 2)
    # squared L2 via the expanded form (one product)
    f2 = torch.sum(feat * feat, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1)[:, None, :]
    return f2 + c2 - 2.0 * (feat @ centers.transpose(1, 2))


def _segment_means(feat, one_hot, fallback):
    """one_hot: (B, T, K); empty clusters take `fallback` rows (B, K, F)."""
    counts = torch.sum(one_hot, dim=1)                     # (B, K)
    sums = one_hot.transpose(1, 2) @ feat                  # (B, K, F)
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    return torch.where((counts > 0)[..., None], means, fallback)


def _assign(feat, centers, distance):
    k = centers.shape[1]
    return F.one_hot(torch.argmin(_distances(feat, centers, distance),
                                  dim=-1), k).to(feat.dtype)


def initial_indices(b: int, t: int, k: int, rng=None, device=None):
    """(B, K) distinct frame indices per row, one device call for the whole
    batch; ``rng`` a torch.Generator on ``device``, None for seed 0."""
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    return torch.argsort(torch.rand((b, t), generator=rng, device=device),
                         dim=1)[:, :k]


def kmeans_compress_batch(feat: torch.Tensor, ratio: float, rng=None,
                          n_iters: int = 20, distance: str = "L2",
                          init_idx=None) -> torch.Tensor:
    """feat: (B, T, F) -> (B, K, F) cluster means, K = int(T * ratio),
    differentiable w.r.t. feat.  The initial centres are the frames
    ``init_idx`` (B, K), drawn from ``rng`` when not given.  Empty cluster
    i falls back to its current centre inside the loop and to the live
    feat[:, i] in the final recompute (reference feature_level.py:210-211,
    its "force" path)."""
    b, t, f = feat.shape
    k = max(int(t * ratio), 1)
    if init_idx is None:
        init_idx = initial_indices(b, t, k, rng, feat.device)
    init_idx = torch.as_tensor(init_idx, dtype=torch.int64,
                               device=feat.device)
    if init_idx.shape != (b, k):
        raise ValueError(f"init_idx {tuple(init_idx.shape)} != {(b, k)}")
    one_hot = kmeans_assign(feat, init_idx, n_iters, distance)
    # differentiable recompute from the live features
    return _segment_means(feat, one_hot, feat[:, :k])


@torch.no_grad()
def kmeans_assign(feat, init_idx, n_iters: int = 20, distance: str = "L2"):
    """The final (B, T, K) one-hot assignment of ``n_iters`` Lloyd steps on
    the detached ``feat`` from the initial frames ``init_idx`` (B, K)."""
    b, _, f = feat.shape
    fs = feat.detach()
    centers = torch.gather(fs, 1, init_idx[..., None].expand(
        b, init_idx.shape[1], f))
    for _ in range(n_iters):
        centers = _segment_means(fs, _assign(fs, centers, distance), centers)
    return _assign(fs, centers, distance)


# ---------------------------------------------------------------------------
# warped k-means (contiguous time segments)
# ---------------------------------------------------------------------------

def _ts_boundaries(feat: np.ndarray, k: int) -> np.ndarray:
    """Trajectory-split init: boundaries at equal cumulative path length
    (reference feature_level.py:53-77)."""
    n = len(feat)
    dist = np.zeros(n)
    for i in range(1, n):
        dist[i] = dist[i - 1] + np.linalg.norm(feat[i] - feat[i - 1])
    seg = dist[n - 1] / k
    boundary = [0]
    idx = 0
    for j in range(1, k):
        req = seg * j
        while idx < n and (req > dist[idx] or idx in boundary):
            idx += 1
        boundary.append(idx)
    boundary = np.array(boundary, dtype=np.int64)
    surpass = np.where(boundary == n)[0]
    if len(surpass):
        for i, bi in enumerate(surpass):
            boundary[bi] = n - len(surpass) + i
        for i in range(surpass[0] - 1, 1, -1):
            if boundary[i] >= boundary[i + 1]:
                boundary[i] = boundary[i + 1] - 1
            else:
                break
    return boundary


def _wk_boundaries_host(feat: np.ndarray, k: int, delta: float,
                        init: str, seed: int) -> np.ndarray:
    """Sequential warped-kmeans boundary optimization (host; the reference
    runs the same loop in Python, feature_level.py:114-154)."""
    n, _ = feat.shape
    if init == "ts":
        boundary = _ts_boundaries(feat, k)
    else:
        rs = np.random.RandomState(seed)
        boundary = np.concatenate(
            [[0], np.sort(rs.choice(np.arange(1, n), size=k - 1,
                                    replace=False))]).astype(np.int64)
    bp = np.concatenate([boundary, [n]])
    counts = (bp[1:] - bp[:-1]).astype(np.int64)
    means = np.stack([feat[bp[i]:bp[i + 1]].mean(0) for i in range(k)])

    def delta_sqe(x, mj, ml, cj, cl):
        return (((x - ml) ** 2).sum() * cl / (cl + 1)
                - ((x - mj) ** 2).sum() * cj / (cj - 1))

    cont = True
    while cont:
        cont = False
        for i in range(k):
            if i > 0:
                begin = boundary[i]
                end = begin + math.floor(counts[i] / 2 * (1 - delta))
                for j in range(begin, end):
                    d = delta_sqe(feat[j], means[i], means[i - 1],
                                  counts[i], counts[i - 1])
                    if counts[i] > 1 and d < 0:
                        cont = True
                        boundary[i] += 1
                        counts[i] -= 1
                        counts[i - 1] += 1
                        means[i] -= (feat[j] - means[i]) / counts[i]
                        means[i - 1] += (feat[j] - means[i - 1]) / counts[i - 1]
                    else:
                        break
            if i < k - 1:
                end = boundary[i + 1] - 1
                begin = end - math.floor(counts[i] / 2 * (1 - delta))
                for j in range(end, begin, -1):
                    d = delta_sqe(feat[j], means[i], means[i + 1],
                                  counts[i], counts[i + 1])
                    if counts[i] > 1 and d < 0:
                        cont = True
                        boundary[i + 1] -= 1
                        counts[i] -= 1
                        counts[i + 1] += 1
                        means[i] -= (feat[j] - means[i]) / counts[i]
                        means[i + 1] += (feat[j] - means[i + 1]) / counts[i + 1]
                    else:
                        break
    return boundary


def warped_kmeans_compress(feat: torch.Tensor, ratio: float,
                           init: str = "random", delta: float = 0.0,
                           seed: int = 0) -> torch.Tensor:
    """feat: (B, T, F) -> (B, K, F); differentiable segment means with
    host-computed segment boundaries (from the detached features in
    float64)."""
    b, t, f = feat.shape
    k = max(int(t * ratio), 1)
    host = feat.detach().cpu().numpy().astype(np.float64)
    boundaries = torch.as_tensor(
        np.stack([_wk_boundaries_host(xi, k, delta, init, seed)
                  for xi in host]), device=feat.device)
    # frame t belongs to segment sum(boundary <= t) - 1
    frame_idx = torch.arange(t, device=feat.device)[None, :, None]
    seg_of_frame = torch.sum(boundaries[:, None, :] <= frame_idx,
                             dim=-1) - 1                       # (B, T)
    one_hot = F.one_hot(seg_of_frame, k).to(feat.dtype)        # (B, T, K)
    counts = torch.sum(one_hot, dim=1)                         # (B, K)
    sums = torch.einsum("btk,btf->bkf", one_hot, feat)
    return sums / torch.clamp(counts, min=1.0)[..., None]
