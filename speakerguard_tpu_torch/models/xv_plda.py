"""x-vector TDNN + PLDA speaker recognition system.

Port of speakerguard_tpu/models/xv_plda.py (reference model/xv_plda.py):
MFCC (num_ceps=30) -> sliding CMVN -> TDNN embedding -> mean-sub -> LDA ->
length-norm -> PLDA, batched and differentiable end to end.

Feature flags (xv_plda.py:45-47): 0=wav, 1=raw MFCC, 2=CMVN (no deltas).

``XvPlda(params, fast=...)`` configures the attack-gradient path
(``models.base.FastPath``; None turns it on when the model's buffers lie on
a CUDA device and off on the CPU, as the JAX package's SG_FAST=auto does per
backend): the bf16 DFT in the frontend (``dft_bf16``) and the TDNN's fast
blocks (``tdnn_fast``, ``tdnn_bf16_act``).  The model has no per-run fast
context.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models import ivector as iv_mod
from speakerguard_tpu_torch.models import plda as plda_mod
from speakerguard_tpu_torch.models.base import (FastPath, NEG_INF, SRSModel,
                                                tree_leaves, tree_rebuild)
from speakerguard_tpu_torch.models.tdnn import (TDNNParams,
                                                load_tdnn_from_torch_state,
                                                random_tdnn, tdnn_embedding)
from speakerguard_tpu_torch.ops.cmvn import sliding_cmvn
from speakerguard_tpu_torch.ops.kaldi_mfcc import XV_PLDA_MFCC, kaldi_mfcc
from speakerguard_tpu_torch.utils import kaldi_io
from speakerguard_tpu_torch.utils.profiling import annotate


class XvPldaParams(NamedTuple):
    tdnn: TDNNParams
    plda: plda_mod.PLDAParams
    emb_mean: torch.Tensor       # (512,)
    transform_mat: torch.Tensor  # (R, 513) LDA affine


def random_xv_plda_params(rng: np.random.Generator, reduced_dim: int = 150,
                          device=None) -> XvPldaParams:
    """Random fixture drawn from ``rng`` in the same order as the JAX
    package's random_xv_plda_params."""
    dev = resolve_device(device)
    tdnn = random_tdnn(rng, device=dev)
    plda = plda_mod.random_plda(rng, reduced_dim, device=dev)
    emb_mean = rng.standard_normal(512) * 0.1
    transform_mat = rng.standard_normal((reduced_dim, 513)) * 0.05
    return XvPldaParams(
        tdnn=tdnn, plda=plda,
        emb_mean=torch.as_tensor(emb_mean, dtype=torch.float32, device=dev),
        transform_mat=torch.as_tensor(transform_mat, dtype=torch.float32,
                                      device=dev))


def load_xv_plda_params(extractor_ckpt, plda_file, mean_file,
                        transform_mat_file, device=None) -> XvPldaParams:
    """Parameters from the reference's TDNN checkpoint (a path that
    ``torch.load`` reads, or the state dict itself) and the Kaldi text
    artifacts."""
    dev = resolve_device(device)
    if not isinstance(extractor_ckpt, dict):
        extractor_ckpt = torch.load(extractor_ckpt, map_location="cpu")
    p = kaldi_io.parse_plda_file(plda_file)
    return XvPldaParams(
        tdnn=load_tdnn_from_torch_state(extractor_ckpt, device=dev),
        plda=plda_mod.build_plda(p["mean"], p["transform"], p["psi"],
                                 device=dev),
        emb_mean=torch.as_tensor(kaldi_io.parse_mean_file(mean_file),
                                 dtype=torch.float32, device=dev),
        transform_mat=torch.as_tensor(
            kaldi_io.parse_transform_mat_file(transform_mat_file),
            dtype=torch.float32, device=dev),
    )


def process_emb(params: XvPldaParams, emb: torch.Tensor) -> torch.Tensor:
    """mean-sub -> LDA affine -> length-norm -> PLDA transform, the chain
    iv_plda uses (the reference inherits it)."""
    with annotate("sg.plda"):
        x = emb - params.emb_mean
        w, b = params.transform_mat[:, :-1], params.transform_mat[:, -1]
        x = x @ w.T + b
        x = iv_mod.length_normalize(x, math.sqrt(float(x.shape[-1])))
        return plda_mod.transform_ivector(params.plda, x, num_examples=1,
                                          simple_length_norm=False,
                                          normalize_length=True)


class XvPlda(SRSModel):
    """The parameters are registered as buffers named by their path in
    ``XvPldaParams`` (``tdnn__conv_w__0``, ``emb_mean``, ...) so
    ``.to(device)`` moves them; ``params`` reassembles the tuples."""

    allowed_flags = (0, 1, 2)
    range_type = "origin"

    def __init__(self, params: XvPldaParams, model_file: str | None = None,
                 threshold: float | None = None, mfcc_config=XV_PLDA_MFCC,
                 fast: FastPath | None = None):
        super().__init__()
        self.fast = fast
        self._template = tree_rebuild(params, lambda name: None)  # the shape
        for name, t in tree_leaves(params):
            self.register_buffer(name, t)
        self.mfcc_config = mfcc_config
        self.threshold = threshold if threshold is not None else NEG_INF
        self._init_enrollment(model_file)

    @property
    def params(self) -> XvPldaParams:
        return tree_rebuild(self._template, lambda n: getattr(self, n))

    def _raw(self, wav, rng=None, fast=False):
        fp = self._fast_on(fast)
        return kaldi_mfcc(wav, self.mfcc_config, rng=rng,
                          fast_dft=fp is not None and fp.dft_bf16)

    def _feat_step(self, feats, ori_flag):
        if ori_flag == 1:
            return sliding_cmvn(feats)
        raise ValueError(ori_flag)

    def _embedding_from_top(self, feats, fast=False, fast_ctx=None):
        p = self.params
        with annotate("sg.tdnn"):
            emb = tdnn_embedding(p.tdnn, feats, fast=self._fast_on(fast))
        return process_emb(p, emb)

    def _scores_from_emb(self, emb, enroll_embs=None):
        with annotate("sg.plda"):
            return plda_mod.llr_scores(self.params.plda,
                                       self._enrolled(enroll_embs), emb,
                                       num_examples=1)
