"""Kaldi two-covariance PLDA transform + log-likelihood-ratio scoring.

Port of speakerguard_tpu/models/plda.py (reference model/_iv_plda/plda.py):
a matmul and elementwise chain, batched over test utterances and enrolled
speakers.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device

_LOG_2PI = math.log(2.0 * math.pi)


class PLDAParams(NamedTuple):
    mean: torch.Tensor       # (D,)
    transform: torch.Tensor  # (D, D)
    psi: torch.Tensor        # (D,) between-class variances, transformed space

    @property
    def dim(self):
        return self.mean.shape[0]


def build_plda(mean: np.ndarray, transform: np.ndarray, psi: np.ndarray,
               device=None) -> PLDAParams:
    dev = resolve_device(device)
    return PLDAParams(*(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                        for a in (mean, transform, psi)))


def random_plda(rng: np.random.Generator, dim: int = 200,
                device=None) -> PLDAParams:
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return build_plda(rng.standard_normal(dim) * 0.1, q,
                      np.abs(rng.standard_normal(dim)) + 0.5, device=device)


def transform_ivector(params: PLDAParams, ivector: torch.Tensor,
                      num_examples: int = 1, simple_length_norm: bool = False,
                      normalize_length: bool = True) -> torch.Tensor:
    """ivector: (..., D) -> transformed (..., D) (reference plda.py:73-97)."""
    d = params.dim
    x = (ivector - params.mean) @ params.transform.T
    if simple_length_norm:
        factor = math.sqrt(float(d)) / torch.linalg.norm(x, dim=-1,
                                                         keepdim=True)
    elif normalize_length:
        inv_covar = 1.0 / (params.psi + 1.0 / num_examples)
        factor = torch.sqrt(
            d / torch.sum(inv_covar * x * x, dim=-1, keepdim=True))
    else:
        factor = torch.ones_like(x[..., :1])
    return x * factor


def llr_scores(params: PLDAParams, enroll: torch.Tensor, test: torch.Tensor,
               num_examples: int = 1) -> torch.Tensor:
    """enroll: (S, D) transformed speaker ivectors; test: (B, D) transformed
    test ivectors -> (B, S) log-likelihood ratios (reference plda.py:140-190,
    batched over both axes)."""
    d = params.dim
    psi = params.psi
    mean = (num_examples * psi / (num_examples * psi + 1.0))[None, :] * enroll
    var_given = 1.0 + psi / (num_examples * psi + 1.0)          # (D,)
    logdet_given = torch.sum(torch.log(var_given))
    sqdiff = (test[:, None, :] - mean[None, :, :]) ** 2          # (B, S, D)
    ll_given = -0.5 * (logdet_given + _LOG_2PI * d
                       + torch.einsum("bsd,d->bs", sqdiff, 1.0 / var_given))
    var_without = psi + 1.0
    logdet_without = torch.sum(torch.log(var_without))
    ll_without = -0.5 * (logdet_without + _LOG_2PI * d
                         + (test ** 2) @ (1.0 / var_without))    # (B,)
    return ll_given - ll_without[:, None]
