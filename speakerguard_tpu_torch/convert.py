"""Carry the JAX package's iv-PLDA weights across to the port.

``from_jax_params(tree)`` takes a speakerguard_tpu ``IvPldaParams`` whose
leaves were turned into numpy arrays (e.g. ``jax.tree.map(np.asarray, p)``),
or anything with the same attribute names, and returns the port's
``IvPldaParams`` with every field as a float32 tensor on ``device``.  The
JAX-side precomputes (``quad_proj``, ``quad_packed``, ``proj``, ``means``)
are taken as given, so both packages compute from identical numbers.  The
bf16 fast-path copies (``quad_proj_bf16``, ``quad_packed_bf16``,
``proj_bf16``) are made as the JAX package makes them, by rounding the
carried float32 tensors to bf16 (round to nearest even on both sides):
when the JAX tree holds them, or when ``fast_copies`` asks (default: on a
CUDA device, where the port's fast path runs by default).
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


def _convert(cls, src, dev, fast_copies):
    """The tuple's float32 fields carried over; each ``<name>_bf16`` field
    (listed after ``<name>``) is the bf16 rounding of the carried
    ``<name>``."""
    out = {}
    for f in cls._fields:
        if not f.endswith("_bf16"):
            out[f] = _tensor(getattr(src, f), dev)
        elif fast_copies or getattr(src, f, None) is not None:
            out[f] = out[f[:-len("_bf16")]].to(torch.bfloat16)
    return cls(**out)


def from_jax_params(tree, device=None,
                    fast_copies: bool | None = None) -> IvPldaParams:
    dev = resolve_device(device)
    if fast_copies is None:
        fast_copies = dev.type == "cuda"
    return IvPldaParams(
        fgmm=_convert(FullGMMParams, tree.fgmm, dev, fast_copies),
        extractor=_convert(IvectorExtractorParams, tree.extractor, dev,
                           fast_copies),
        plda=_convert(PLDAParams, tree.plda, dev, fast_copies),
        emb_mean=_tensor(tree.emb_mean, dev),
        transform_mat=_tensor(tree.transform_mat, dev),
    )
