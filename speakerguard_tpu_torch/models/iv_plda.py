"""GMM-UBM i-vector + PLDA speaker recognition system.

Port of speakerguard_tpu/models/iv_plda.py (reference model/iv_plda.py):
wav -> MFCC -> delta -> CMVN -> Baum-Welch stats -> ivector -> LDA ->
length-norm -> PLDA, batched and differentiable end to end.

Feature flags (iv_plda.py:75-77): 0=wav, 1=raw MFCC, 2=+deltas, 3=CMVN.

``IvPlda(params, fast=..., loglike_kernel=..., spd_solver=...)`` picks the
paths: ``fast`` configures the attack-gradient path
(``models.base.FastPath``; None turns it on when the model's buffers lie on
a CUDA device and off on the CPU, as the JAX package's SG_FAST=auto does per
backend), ``loglike_kernel`` routes the exact path's GMM loglike through the
fused kernel (ops/gmm_loglike.py; the JAX package's SG_GMM_PALLAS=1), and
``spd_solver`` picks the kernel of the i-vector SPD solve on the exact and
the fast path alike (models/ivector.py ``spd_solve``), as the JAX package's
variables do:

  "cholesky_rt"       SG_CHOL_PALLAS=1 (the default)
  "cholesky_rt_dinv"  SG_CHOL_PALLAS=1 and SG_CHOL_EMIT_DINV=1
  "chol_solve"        SG_CHOL_PALLAS=fused
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models import gmm as gmm_mod
from speakerguard_tpu_torch.models import ivector as iv_mod
from speakerguard_tpu_torch.models import plda as plda_mod
from speakerguard_tpu_torch.models.base import FastPath, NEG_INF, SRSModel
from speakerguard_tpu_torch.ops.cmvn import sliding_cmvn
from speakerguard_tpu_torch.ops.delta import add_delta
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC, kaldi_mfcc
from speakerguard_tpu_torch.utils import kaldi_io


class IvPldaParams(NamedTuple):
    fgmm: gmm_mod.FullGMMParams
    extractor: iv_mod.IvectorExtractorParams
    plda: plda_mod.PLDAParams
    emb_mean: torch.Tensor       # (IV,) global ivector mean
    transform_mat: torch.Tensor  # (R, IV+1) LDA affine transform


def random_iv_plda_params(rng: np.random.Generator, num_gaussians: int = 2048,
                          dim: int = 72, ivector_dim: int = 600,
                          reduced_dim: int = 200,
                          device=None) -> IvPldaParams:
    """Random fixture drawn from ``rng`` in the same order as the JAX
    package's random_iv_plda_params.  dim=72 = num_ceps(24) x 3."""
    dev = resolve_device(device)
    fgmm = gmm_mod.random_gmm(rng, num_gaussians, dim, device=dev)
    extractor = iv_mod.random_extractor(rng, num_gaussians, dim, ivector_dim,
                                        device=dev)
    plda = plda_mod.random_plda(rng, reduced_dim, device=dev)
    emb_mean = rng.standard_normal(ivector_dim) * 0.1
    transform_mat = rng.standard_normal((reduced_dim, ivector_dim + 1)) * 0.05
    return IvPldaParams(
        fgmm=fgmm, extractor=extractor, plda=plda,
        emb_mean=torch.as_tensor(emb_mean, dtype=torch.float32, device=dev),
        transform_mat=torch.as_tensor(transform_mat, dtype=torch.float32,
                                      device=dev))


def load_iv_plda_params(fgmm_file, extractor_file, plda_file, mean_file,
                        transform_mat_file, device=None) -> IvPldaParams:
    """Parameters from the Kaldi text artifacts."""
    dev = resolve_device(device)
    g = kaldi_io.parse_fgmm_file(fgmm_file)
    e = kaldi_io.parse_extractor_file(extractor_file)
    p = kaldi_io.parse_plda_file(plda_file)
    return IvPldaParams(
        fgmm=gmm_mod.build_gmm(g["gconsts"], g["weights"],
                               g["means_invcovars"], g["invcovars"],
                               device=dev),
        extractor=iv_mod.build_extractor(e["extractor_matrix"],
                                         e["sigma_inv"], float(e["offset"]),
                                         device=dev),
        plda=plda_mod.build_plda(p["mean"], p["transform"], p["psi"],
                                 device=dev),
        emb_mean=torch.as_tensor(kaldi_io.parse_mean_file(mean_file),
                                 dtype=torch.float32, device=dev),
        transform_mat=torch.as_tensor(
            kaldi_io.parse_transform_mat_file(transform_mat_file),
            dtype=torch.float32, device=dev),
    )


# ----- pure functions ------------------------------------------------------

def process_emb(params: IvPldaParams, ivec: torch.Tensor) -> torch.Tensor:
    """mean-sub -> LDA affine reduce -> length-norm -> PLDA transform
    (reference iv_plda.py:411-443), batched over (B, IV)."""
    x = ivec - params.emb_mean
    w, b = params.transform_mat[:, :-1], params.transform_mat[:, -1]
    x = x @ w.T + b
    x = iv_mod.length_normalize(x, math.sqrt(float(x.shape[-1])))
    return plda_mod.transform_ivector(params.plda, x, num_examples=1,
                                      simple_length_norm=False,
                                      normalize_length=True)


class IvFastContext(NamedTuple):
    """Per-attack-run frozen top-K Gaussian selection: the shared GMM
    selection plus the matching i-vector extractor slices."""
    gmm: gmm_mod.GmmTopKContext
    iv: iv_mod.IvectorTopK


def make_fast_context(params: IvPldaParams, feats: torch.Tensor,
                      k: int, shard=None) -> IvFastContext | None:
    """Shared top-K selection from (clean) CMVN features + extractor
    slices.  None when selection is a no-op (K <= 0 or K >= C).
    ``shard``: ``feats`` are this rank's rows (``make_topk_context``)."""
    g = gmm_mod.make_topk_context(params.fgmm, feats, k, shard)
    if g is None:
        return None
    return IvFastContext(gmm=g,
                         iv=iv_mod.make_topk_slices(params.extractor, g.sel))


def embedding_from_cmvn(params: IvPldaParams, feats: torch.Tensor,
                        fast: FastPath | None = None,
                        topk_ctx: IvFastContext | None = None,
                        loglike_kernel: bool = False,
                        spd_solver: str = "cholesky_rt") -> torch.Tensor:
    """(B, T, D) CMVN features -> (B, R) processed embeddings.

    ``fast`` (a FastPath; None = exact) runs the bf16 attack-gradient
    variant of the GMM stats and i-vector extraction, restricted to
    ``topk_ctx``'s frozen selection when given; scores drift at the bf16
    level, so callers keep success decisions on the exact path.
    ``loglike_kernel`` (exact path) routes the loglike through the fused
    kernel; ``spd_solver`` picks the SPD solve's kernel."""
    if feats.shape[-1] != params.fgmm.dim:
        raise ValueError(
            f"feature dim {feats.shape[-1]} != UBM dim {params.fgmm.dim}; "
            "check num_ceps (features are num_ceps*3 after deltas)")
    zeroth, first = gmm_mod.zeroth_first_stats(
        params.fgmm, feats, fast=fast,
        topk_ctx=None if topk_ctx is None else topk_ctx.gmm,
        loglike_kernel=loglike_kernel)
    ivec = iv_mod.extract_ivectors(
        params.extractor, zeroth, first, fast=fast,
        topk=None if topk_ctx is None else topk_ctx.iv,
        spd_solver=spd_solver)
    return process_emb(params, ivec)


def scores_from_emb(params: IvPldaParams, emb: torch.Tensor,
                    enroll_embs: torch.Tensor) -> torch.Tensor:
    return plda_mod.llr_scores(params.plda, enroll_embs, emb, num_examples=1)


# ----- model class ----------------------------------------------------------

_GROUPS = {"fgmm": gmm_mod.FullGMMParams,
           "extractor": iv_mod.IvectorExtractorParams,
           "plda": plda_mod.PLDAParams}


class IvPlda(SRSModel):
    """The parameters are registered as buffers (``fgmm__quad_proj``, ...,
    the bf16 copies included where the tuples carry them) so ``.to(device)``
    moves them; ``params`` reassembles the tuples."""

    allowed_flags = (0, 1, 2, 3)
    range_type = "origin"

    def __init__(self, params: IvPldaParams, model_file: str | None = None,
                 threshold: float | None = None, mfcc_config=IV_PLDA_MFCC,
                 fast: FastPath | None = None, loglike_kernel: bool = False,
                 spd_solver: str = "cholesky_rt"):
        super().__init__()
        if spd_solver not in iv_mod.SPD_SOLVERS:
            raise ValueError(f"spd_solver {spd_solver!r} not in "
                             f"{iv_mod.SPD_SOLVERS}")
        self.fast = fast
        self.loglike_kernel = loglike_kernel
        self.spd_solver = spd_solver
        for group, cls in _GROUPS.items():
            sub = getattr(params, group)
            for field in cls._fields:
                self.register_buffer(f"{group}__{field}", getattr(sub, field))
        self.register_buffer("emb_mean", params.emb_mean)
        self.register_buffer("transform_mat", params.transform_mat)
        self.mfcc_config = mfcc_config
        self.threshold = threshold if threshold is not None else NEG_INF
        self._init_enrollment(model_file)

    @property
    def params(self) -> IvPldaParams:
        groups = {g: cls(*(getattr(self, f"{g}__{f}") for f in cls._fields))
                  for g, cls in _GROUPS.items()}
        return IvPldaParams(emb_mean=self.emb_mean,
                            transform_mat=self.transform_mat, **groups)

    def _raw(self, wav, rng=None, fast=False):
        fp = self._fast_on(fast)
        return kaldi_mfcc(wav, self.mfcc_config, rng=rng,
                          fast_dft=fp is not None and fp.dft_bf16)

    def _feat_step(self, feats, ori_flag):
        if ori_flag == 1:
            return add_delta(feats)
        if ori_flag == 2:
            return sliding_cmvn(feats)
        raise ValueError(ori_flag)

    def _embedding_from_top(self, feats, fast=False, fast_ctx=None):
        fp = self._fast_on(fast)
        return embedding_from_cmvn(
            self.params, feats, fast=fp,
            topk_ctx=fast_ctx if fp is not None else None,
            loglike_kernel=self.loglike_kernel, spd_solver=self.spd_solver)

    def fast_context(self, x, shard=None):
        """The frozen batch-shared top-K Gaussian selection of an attack
        run (``FastPath.gmm_topk``), from the run's clean input on the fast
        frontend without dither; None when the fast path or the selection
        is off."""
        fp = self.fast_path
        if fp is None or fp.gmm_topk <= 0:
            return None
        with torch.no_grad():
            feats = self.compute_feat(x, flag=self.allowed_flags[-1],
                                      fast=True)
            return make_fast_context(self.params, feats, fp.gmm_topk, shard)

    def _scores_from_emb(self, emb, enroll_embs=None):
        return scores_from_emb(self.params, emb, self._enrolled(enroll_embs))

