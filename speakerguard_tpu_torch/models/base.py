"""Uniform SRS model protocol.

Every model exposes the reference's five-method surface
(reference model/iv_plda.py:86-194):

    compute_feat(x, flag)             wav -> acoustic feature at `flag` level
    comput_feat_from_feat(f, o, d)    feature-ladder transitions
    embedding(x, flag)                any level -> speaker embedding
    forward/score(x, flag)            -> (B, S) scores
    make_decision(x, flag)            -> (decisions, scores); -1 = reject

plus the attributes attacks and defenses key on: ``allowed_flags``,
``range_type``, ``threshold``, ``spk_ids``/``num_spks``.

The "flag" ladder is the cross-layer contract that lets defenses insert at
any feature level (reference model/defended_model.py).  Models are
``nn.Module``s holding their parameters as buffers; attacks differentiate
through ``score`` with ``torch.autograd``.
"""

from dataclasses import dataclass

import torch
from torch import nn

from speakerguard_tpu_torch.utils import kaldi_io
from speakerguard_tpu_torch.utils.ranges import check_input_range

NEG_INF = float("-inf")


@dataclass(frozen=True)
class FastPath:
    """Configuration of the bf16 fast attack-gradient path.

    The JAX package reads process-wide ``SG_*`` variables; the port takes
    this object instead and reads no environment variable.  Each default is
    the JAX default on the accelerator.  Attack iterations score through
    this path; every final success decision stays on the exact path.
    Field, the JAX variable it mirrors (where speakerguard_tpu reads it):

    enabled            SG_FAST (models/base.py fast_active): the path at all.
    gmm_topk           SG_GMM_TOPK (models/gmm.py topk_k): components of the
                       batch-shared Gaussian selection frozen per attack run
                       (0 disables it).
    stats_kernel       SG_GMM_STATS_PALLAS=1 (models/gmm.py
                       _use_stats_pallas): the fused stats kernels
                       (ops/gmm_stats.py here).  A top-K context takes
                       precedence, so they run only with gmm_topk=0.
    stats_t_chunk      SG_GMM_STATS_TCHUNK (models/gmm.py stats_t_chunk):
                       frames per chunk of the unfused stats (0 = one shot).
    ivec_l_bf16        SG_IVEC_L_BF16 (models/ivector.py ivec_l_bf16_active):
                       the i-vector precision matrix L is assembled in bf16.
    chol_bf16_updates  SG_CHOL_BF16 on the fast path (models/ivector.py
                       _chol_factor): bf16 trailing updates in cholesky_rt.
    dft_bf16           SG_DFT_FAST_PRECISION=default (models/base.py
                       fast_dft_precision): the frontend's two DFT matmuls
                       take bf16 operands with f32 accumulation.
    tdnn_fast          SG_TDNN_FAST (models/tdnn.py tdnn_fast_bwd_active):
                       the x-vector TDNN's conv blocks and stats pooling run
                       as hand-written autograd Functions that save the ReLU
                       mask instead of the activations.
    tdnn_bf16_act      SG_TDNN_BF16_ACT (models/tdnn.py tdnn_bf16_act_active):
                       with tdnn_fast, the TDNN's activations and their
                       cotangents flow in bf16 between layers, on the CPU
                       too, as in the JAX package.
    audionet_bf16      SG_AUDIONET_BF16 (models/audionet.py
                       audionet_bf16_active): AudioNet's CNN runs with bf16
                       weights, running stats and activations (conv -> BN
                       -> ReLU -> pool), on the CPU too, as in the JAX
                       package; its fc head stays float32.

    The TPU-only knobs SG_GMM_PRECISION, SG_GMM_BWD_PRECISION, SG_CHOL_NB,
    SG_CHOL_BTILE and SG_CHOL_BF16_IN have no counterpart: they set MXU pass
    counts or VMEM tiles, and the port's exact path is float32 with TF32
    off.  As in the JAX package, where the fast path computes in bf16 on the
    accelerator it computes in float32 on the bf16-rounded weight copies on
    the CPU (``models.gmm.fast_dot_dtype``).
    """

    enabled: bool = True
    gmm_topk: int = 256
    stats_kernel: bool = False
    stats_t_chunk: int = 0
    ivec_l_bf16: bool = True
    chol_bf16_updates: bool = True
    dft_bf16: bool = True
    tdnn_fast: bool = True
    tdnn_bf16_act: bool = True
    audionet_bf16: bool = True


def _children(tree):
    names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
    return zip(names, tree)


def tree_leaves(tree, prefix=""):
    """(buffer name, leaf) for every leaf of a nest of NamedTuples and
    tuples: ``tdnn__conv_w__0``, ``plda__mean``, ..."""
    for name, sub in _children(tree):
        path = f"{prefix}__{name}" if prefix else str(name)
        if isinstance(sub, tuple):
            yield from tree_leaves(sub, path)
        else:
            yield path, sub


def tree_rebuild(template, get, prefix=""):
    """The nest shaped like ``template`` with each leaf ``get(name)``."""
    out = []
    for name, sub in _children(template):
        path = f"{prefix}__{name}" if prefix else str(name)
        out.append(tree_rebuild(sub, get, path) if isinstance(sub, tuple)
                   else get(path))
    return type(template)(*out) if hasattr(template, "_fields") else tuple(out)


def tree_map(fn, *trees):
    """The nest shaped like ``trees[0]`` with each leaf ``fn`` of the leaves
    at the same place in every tree."""
    leaves = [dict(tree_leaves(t)) for t in trees]
    return tree_rebuild(trees[0], lambda n: fn(*(d[n] for d in leaves)))


def decide(scores: torch.Tensor, threshold: float):
    """argmax + reject threshold (reference iv_plda.py:182-194)."""
    decisions = torch.argmax(scores, dim=1).to(torch.int32)
    max_scores = torch.max(scores, dim=1).values
    reject = torch.full_like(decisions, -1)
    return torch.where(max_scores > threshold, decisions, reject), scores


def as_batch_wav(x: torch.Tensor) -> torch.Tensor:
    """Accept (L,), (B, L) or (B, 1, L); return (B, L)."""
    if x.ndim == 1:
        return x[None, :]
    if x.ndim == 3:
        if x.shape[1] != 1:
            raise ValueError("only mono audio")
        return x[:, 0, :]
    if x.ndim != 2:
        raise ValueError(f"expected (L,), (B, L) or (B, 1, L), got "
                         f"{tuple(x.shape)}")
    return x


class SRSModel(nn.Module):
    """Subclasses set: allowed_flags, range_type, threshold, spk_ids and
    implement _raw / _feat_step / _embedding_from_top / _scores_from_emb."""

    allowed_flags: tuple = (0, 1)
    range_type: str = "origin"
    threshold: float = NEG_INF
    spk_ids: list = None
    fast: FastPath | None = None

    @property
    def num_spks(self) -> int:
        return len(self.spk_ids) if self.spk_ids is not None else None

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    @property
    def fast_path(self) -> FastPath | None:
        """The fast path's configuration, or None when it is off: ``fast``
        as given, and for ``fast=None`` the defaults on a CUDA device and
        off on the CPU (the JAX package's SG_FAST=auto)."""
        fast = self.fast
        if fast is None:
            fast = FastPath(enabled=self.device.type == "cuda")
        return fast if fast.enabled else None

    def _fast_on(self, fast: bool) -> FastPath | None:
        return self.fast_path if fast else None

    # ---- enrolled speakers ----
    def _init_enrollment(self, model_file):
        """No speakers yet, or those of a Kaldi-format enroll model file;
        call after the parameters are registered."""
        self.spk_ids = None
        self.z_norm_means = self.z_norm_stds = None
        self.register_buffer("enroll_embs", None)
        if model_file is not None:
            (_, spk_ids, z_means, z_stds,
             embs) = kaldi_io.parse_enroll_model_file(model_file)
            self.set_enrollment(spk_ids, embs, z_means, z_stds)

    def set_enrollment(self, spk_ids, enroll_embs, z_norm_means=None,
                       z_norm_stds=None):
        self.spk_ids = list(spk_ids)
        self.enroll_embs = torch.as_tensor(enroll_embs, dtype=torch.float32,
                                           device=self.device)
        self.z_norm_means = z_norm_means
        self.z_norm_stds = z_norm_stds

    def _enrolled(self, enroll_embs=None) -> torch.Tensor:
        """``enroll_embs`` when given, else the enrolled speakers'."""
        enroll = enroll_embs if enroll_embs is not None else self.enroll_embs
        if enroll is None:
            raise ValueError("model has no enrolled speakers")
        return enroll

    # ---- ladder pieces (override) ----------------------------------------
    def _raw(self, wav, rng=None, fast=False):
        raise NotImplementedError

    def _feat_step(self, feats, ori_flag):
        raise NotImplementedError

    def _embedding_from_top(self, feats, fast=False, fast_ctx=None):
        raise NotImplementedError

    def _scores_from_emb(self, emb, enroll_embs=None):
        raise NotImplementedError

    # ---- per-attack-run fast-path context ----
    def fast_context(self, x, shard=None):
        """Per-run constants of the fast attack-gradient path, computed once
        from the attack's clean input (iv_plda's frozen top-K Gaussian
        selection).  Models without one return None; attacks pass the
        result back through ``fast_ctx=``.  Never affects the exact path.
        ``shard`` (a ``parallel.mesh.BatchShard``): ``x`` is this rank's
        rows of the batch, and a selection shared by the batch reduces
        over the ranks."""
        return None

    # ---- uniform API ----
    # fast=True marks an attack-gradient graph: models with a fast path
    # (iv_plda, xv_plda) honor it, others ignore it.  make_decision has no
    # such flag: decisions are always exact.
    def compute_feat(self, x, flag=1, rng=None, fast=False):
        assert flag in self.allowed_flags and flag != 0
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        wav = check_input_range(as_batch_wav(x), range_type=self.range_type)
        feats = self._raw(wav, rng=rng, fast=fast)
        for f in range(1, flag):
            feats = self._feat_step(feats, f)
        return feats

    def comput_feat_from_feat(self, feats, ori_flag=1, des_flag=2):
        assert ori_flag in self.allowed_flags and des_flag in self.allowed_flags
        assert 0 < ori_flag < des_flag
        for f in range(ori_flag, des_flag):
            feats = self._feat_step(feats, f)
        return feats

    def embedding(self, x, flag=0, rng=None, fast=False, fast_ctx=None):
        assert flag in self.allowed_flags
        top = self.allowed_flags[-1]
        if flag == 0:
            feats = self.compute_feat(x, flag=top, rng=rng, fast=fast)
        elif flag < top:
            feats = self.comput_feat_from_feat(x, ori_flag=flag, des_flag=top)
        else:
            feats = x
        return self._embedding_from_top(feats, fast=fast, fast_ctx=fast_ctx)

    def forward(self, x, flag=0, return_emb=False, enroll_embs=None,
                rng=None, fast=False, fast_ctx=None):
        emb = self.embedding(x, flag=flag, rng=rng, fast=fast,
                             fast_ctx=fast_ctx)
        scores = self._scores_from_emb(emb, enroll_embs=enroll_embs)
        return (scores, emb) if return_emb else scores

    def score(self, x, flag=0, enroll_embs=None, rng=None, fast=False,
              fast_ctx=None):
        return self.forward(x, flag=flag, enroll_embs=enroll_embs, rng=rng,
                            fast=fast, fast_ctx=fast_ctx)

    def make_decision(self, x, flag=0, enroll_embs=None, rng=None):
        scores = self.score(x, flag=flag, enroll_embs=enroll_embs, rng=rng)
        return decide(scores, self.threshold)

    # ---- reference-API aliases (iv_plda.py:197, :380) ----
    def raw(self, x, rng=None):
        """wav -> flag-1 acoustic features."""
        return self.compute_feat(x, flag=1, rng=rng)

    def extract_emb(self, feats):
        """top-level features -> embeddings."""
        return self._embedding_from_top(feats)
