"""Carry the JAX package's iv-PLDA weights across to the port.

``from_jax_params(tree)`` takes a speakerguard_tpu ``IvPldaParams`` whose
leaves were turned into numpy arrays (e.g. ``jax.tree.map(np.asarray, p)``),
or anything with the same attribute names, and returns the port's
``IvPldaParams`` with every field as a float32 tensor on ``device``.  The
JAX-side precomputes (``quad_proj``, ``quad_packed``, ``proj``, ``means``)
are taken as given, so both packages compute from identical numbers.  The
bf16 fast-path copies of the JAX tuples are not carried (the port has no
fast path yet).
"""

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models.gmm import FullGMMParams
from speakerguard_tpu_torch.models.iv_plda import IvPldaParams
from speakerguard_tpu_torch.models.ivector import IvectorExtractorParams
from speakerguard_tpu_torch.models.plda import PLDAParams


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _convert(cls, src, dev):
    return cls(*(_tensor(getattr(src, f), dev) for f in cls._fields))


def from_jax_params(tree, device=None) -> IvPldaParams:
    dev = resolve_device(device)
    return IvPldaParams(
        fgmm=_convert(FullGMMParams, tree.fgmm, dev),
        extractor=_convert(IvectorExtractorParams, tree.extractor, dev),
        plda=_convert(PLDAParams, tree.plda, dev),
        emb_mean=_tensor(tree.emb_mean, dev),
        transform_mat=_tensor(tree.transform_mat, dev),
    )
