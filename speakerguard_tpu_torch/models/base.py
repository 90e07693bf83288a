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

import torch
from torch import nn

from speakerguard_tpu_torch.utils.ranges import check_input_range

NEG_INF = float("-inf")


def fast_active() -> bool:
    """Gate for the bf16 fast attack-gradient path.

    The port has no fast path yet (bf16 weight copies, top-K Gaussian
    selection and bf16 L come in a later slice), so every graph, attack
    gradients included, runs the exact float32 path."""
    return False


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

    @property
    def num_spks(self) -> int:
        return len(self.spk_ids) if self.spk_ids is not None else None

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    # ---- ladder pieces (override) ----------------------------------------
    def _raw(self, wav, rng=None):
        raise NotImplementedError

    def _feat_step(self, feats, ori_flag):
        raise NotImplementedError

    def _embedding_from_top(self, feats):
        raise NotImplementedError

    def _scores_from_emb(self, emb, enroll_embs=None):
        raise NotImplementedError

    # ---- uniform API ----
    def compute_feat(self, x, flag=1, rng=None):
        assert flag in self.allowed_flags and flag != 0
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        wav = check_input_range(as_batch_wav(x), range_type=self.range_type)
        feats = self._raw(wav, rng=rng)
        for f in range(1, flag):
            feats = self._feat_step(feats, f)
        return feats

    def comput_feat_from_feat(self, feats, ori_flag=1, des_flag=2):
        assert ori_flag in self.allowed_flags and des_flag in self.allowed_flags
        assert 0 < ori_flag < des_flag
        for f in range(ori_flag, des_flag):
            feats = self._feat_step(feats, f)
        return feats

    def embedding(self, x, flag=0, rng=None):
        assert flag in self.allowed_flags
        top = self.allowed_flags[-1]
        if flag == 0:
            feats = self.compute_feat(x, flag=top, rng=rng)
        elif flag < top:
            feats = self.comput_feat_from_feat(x, ori_flag=flag, des_flag=top)
        else:
            feats = x
        return self._embedding_from_top(feats)

    def forward(self, x, flag=0, return_emb=False, enroll_embs=None,
                rng=None):
        emb = self.embedding(x, flag=flag, rng=rng)
        scores = self._scores_from_emb(emb, enroll_embs=enroll_embs)
        return (scores, emb) if return_emb else scores

    def score(self, x, flag=0, enroll_embs=None, rng=None):
        return self.forward(x, flag=flag, enroll_embs=enroll_embs, rng=rng)

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
