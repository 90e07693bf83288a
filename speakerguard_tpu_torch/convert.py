"""Carry the JAX package's iv-PLDA, xv-PLDA and AudioNet weights across to
the port.

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

An ``XvPldaParams`` tree (it has a ``tdnn`` field) comes back as the port's
``XvPldaParams``: the TDNN's (k, in, out) conv weights and (in, out) linear
weights transposed to PyTorch's (out, in, k) and (out, in), every other
field carried as it is.  ``fast_copies`` does not apply: the TDNN's bf16
blocks round their weights as they run, as the JAX package's do.

A JAX ``AudioNet.params`` pair ``(AudioNetParams, AudioNetState)`` comes
back as the port's pair (``models.audionet.from_jax_layout``: conv1's HWIO
weight as OIHW, each block's (k, in, out) weight as (out, in, k)).
"""

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models.audionet import (AudioNetParams,
                                                    AudioNetState,
                                                    from_jax_layout)
from speakerguard_tpu_torch.models.gmm import FullGMMParams
from speakerguard_tpu_torch.models.iv_plda import IvPldaParams
from speakerguard_tpu_torch.models.ivector import IvectorExtractorParams
from speakerguard_tpu_torch.models.plda import PLDAParams
from speakerguard_tpu_torch.models.tdnn import BNStats, TDNNParams
from speakerguard_tpu_torch.models.xv_plda import XvPldaParams


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


def _tdnn(t, dev) -> TDNNParams:
    def bn(s):
        return BNStats(_tensor(s.mean, dev), _tensor(s.var, dev))

    def lin(a):
        return _tensor(np.asarray(a).T, dev)

    return TDNNParams(
        tuple(_tensor(np.asarray(w).transpose(2, 1, 0), dev)
              for w in t.conv_w),
        tuple(_tensor(b, dev) for b in t.conv_b),
        tuple(bn(s) for s in t.bn_tdnn),
        lin(t.fc1_w), _tensor(t.fc1_b, dev), bn(t.bn_fc1),
        lin(t.fc2_w), _tensor(t.fc2_b, dev), bn(t.bn_fc2),
        lin(t.fc3_w), _tensor(t.fc3_b, dev))


def from_jax_params(tree, device=None, fast_copies: bool | None = None
                    ) -> (IvPldaParams | XvPldaParams
                          | tuple[AudioNetParams, AudioNetState]):
    dev = resolve_device(device)
    if not hasattr(tree, "_fields") and hasattr(tree[0], "conv1_w"):
        return from_jax_layout(*tree, device=dev)
    if hasattr(tree, "tdnn"):
        return XvPldaParams(
            tdnn=_tdnn(tree.tdnn, dev),
            plda=_convert(PLDAParams, tree.plda, dev, False),
            emb_mean=_tensor(tree.emb_mean, dev),
            transform_mat=_tensor(tree.transform_mat, dev))
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
