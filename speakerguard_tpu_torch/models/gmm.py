"""Full-covariance GMM (UBM) Baum-Welch statistics, batched.

Port of the exact path of speakerguard_tpu/models/gmm.py (reference
model/_iv_plda/gmm.py).  The frame log-likelihood

    loglike[t,c] = gconsts[c] + m_ic[c]·x_t - 0.5 x_t^T InvCov_c x_t

is one matmul through the packed-symmetric-quadratic augmentation: with
w' = InvCov * (2 - I),

    loglike = [x, packed(x x^T)] @ [m_ic, -0.5 w']^T + gconsts

where packed() takes the upper triangle in ``np.triu_indices`` order.  The
bf16 fast path, top-K Gaussian selection and the fused-kernel dispatches of
the JAX module come in a later slice.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device


class FullGMMParams(NamedTuple):
    gconsts: torch.Tensor          # (C,)
    weights: torch.Tensor          # (C,)
    means_invcovars: torch.Tensor  # (C, D)
    invcovars: torch.Tensor        # (C, D, D) symmetric
    means: torch.Tensor            # (C, D) = InvCov^-1 @ means_invcovars
    quad_proj: torch.Tensor        # (D + D(D+1)//2, C) packed projection

    @property
    def num_gaussians(self) -> int:
        return self.gconsts.shape[0]

    @property
    def dim(self) -> int:
        return self.means_invcovars.shape[1]


def build_gmm(gconsts: np.ndarray, weights: np.ndarray,
              means_invcovars: np.ndarray, invcovars: np.ndarray,
              device=None) -> FullGMMParams:
    """Host-side preprocessing at model load: derive the means and the
    packed quadratic projection matrix (float64 numpy, stored float32)."""
    dev = resolve_device(device)
    c, d = means_invcovars.shape
    means = np.linalg.solve(invcovars, means_invcovars[..., None])[..., 0]
    rows, cols = np.triu_indices(d)
    w = invcovars * np.where(np.eye(d, dtype=bool), 1.0, 2.0)
    packed = w[:, rows, cols]                      # (C, D(D+1)/2)
    proj = np.concatenate([means_invcovars, -0.5 * packed], axis=1).T

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return FullGMMParams(gconsts=f32(gconsts), weights=f32(weights),
                         means_invcovars=f32(means_invcovars),
                         invcovars=f32(invcovars), means=f32(means),
                         quad_proj=f32(proj))


def random_gmm(rng: np.random.Generator, num_gaussians: int = 2048,
               dim: int = 60, device=None) -> FullGMMParams:
    """Random but well-conditioned GMM fixture; draws the same numbers from
    ``rng`` as the JAX package's random_gmm."""
    a = rng.standard_normal((num_gaussians, dim, dim)) * 0.1
    invcov = np.einsum("cij,ckj->cik", a, a) + np.eye(dim) * 1.0
    means = rng.standard_normal((num_gaussians, dim))
    mic = np.einsum("cij,cj->ci", invcov, means)
    _, logdet = np.linalg.slogdet(invcov)
    weights = np.full(num_gaussians, 1.0 / num_gaussians)
    # Kaldi gconst = log(weight) + 0.5 logdet(InvCov) - 0.5 (D log(2pi) + m^T InvCov m)
    gconsts = (np.log(weights) + 0.5 * logdet
               - 0.5 * (dim * np.log(2 * np.pi)
                        + np.einsum("ci,ci->c", means, mic)))
    return build_gmm(gconsts, weights, mic, invcov, device=device)


@functools.lru_cache(maxsize=None)
def _packed_indices(d: int, device: torch.device):
    """np.triu_indices(d) (row <= col) on the device, built once."""
    return tuple(torch.as_tensor(i, device=device) for i in np.triu_indices(d))


def augment(feats: torch.Tensor) -> torch.Tensor:
    """aug(x) = [x, packed(x x^T)]: (..., D) -> (..., D + D(D+1)/2)."""
    rows, cols = _packed_indices(feats.shape[-1], feats.device)
    return torch.cat([feats, feats[..., rows] * feats[..., cols]], dim=-1)


def component_loglike(params: FullGMMParams,
                      feats: torch.Tensor) -> torch.Tensor:
    """feats: (..., T, D) -> per-component loglike (..., T, C)."""
    return augment(feats) @ params.quad_proj + params.gconsts


def posteriors(params: FullGMMParams, feats: torch.Tensor) -> torch.Tensor:
    return torch.softmax(component_loglike(params, feats), dim=-1)


def zeroth_first_stats(params: FullGMMParams, feats: torch.Tensor):
    """feats: (B, T, D) -> (zeroth (B, C), first (B, C, D)).

    Matches reference gmm.py:166-171 (sum of posteriors / posterior-weighted
    frame sum) without the frame-batching loop."""
    posts = posteriors(params, feats)              # (B, T, C)
    zeroth = torch.sum(posts, dim=-2)              # (B, C)
    first = torch.einsum("btc,btd->bcd", posts, feats)
    return zeroth, first
