"""Universal defended-model wrapper.

Port of speakerguard_tpu/models/defended.py (reference
model/defended_model.py): attaches (flag, defense_fn) pairs to a base model
and composes them either sequentially along the feature ladder (computing
features incrementally between flag levels) or as an ensemble average of
scores and embeddings over the defenses.

What the JAX package's wrapper does, and so this one:

  * The base model's frontend runs on the exact f32 path with no dither:
    ``compute_feat`` gets no ``rng`` and no ``fast``.  Only the embedding
    stage sees ``fast=`` (sequential order); the average order scores on
    the exact path throughout.
  * ``fast_context`` returns None, as the JAX wrapper inherits it from the
    base protocol: iv-PLDA's top-K selection, built from clean frames,
    would not fit the frames a defense leaves, so the fast path runs over
    every Gaussian.  ``fast_ctx=`` is accepted (attacks pass it) and is
    always None.
  * ``score`` ignores its ``flag``: the input is a waveform.

Randomness: every defense application gets one draw function,
``draw(kind, shape)`` (defenses/time_domain.py): ``draw_fn`` when one was
given, else ``generator_draw`` over ``rng`` (the attack's
``torch.Generator``), drawn in application order.  The kinds are FeCo's
(B, T) frame order, whose first K frames are its initial centres
(``"kmeans_init"``), AT's (B, L) standard normal noise (``"at_noise"``)
and warped k-means' seed (``"wk_seed"``); the CPU tests pass a
``draw_fn`` that hands out the JAX-drawn values.  With neither, a defense
falls back as the JAX one does (FeCo on seed 0, AT raises).
"""

import warnings

from speakerguard_tpu_torch.defenses.time_domain import generator_draw
from speakerguard_tpu_torch.models.base import SRSModel, decide

SEQUENTIAL = "sequential"
AVERAGE = "average"


class DefendedModel(SRSModel):

    def __init__(self, base_model: SRSModel, defense=None, order=SEQUENTIAL,
                 draw_fn=None):
        super().__init__()
        self.base_model = base_model  # a submodule: .device, .to() follow it
        self.threshold = base_model.threshold
        self.range_type = base_model.range_type
        self.allowed_flags = base_model.allowed_flags
        self.spk_ids = base_model.spk_ids
        self.defense = defense
        self.order = order
        self.draw_fn = draw_fn
        if defense is not None:
            if order not in (SEQUENTIAL, AVERAGE):
                raise ValueError(f"order {order!r}: {SEQUENTIAL} or "
                                 f"{AVERAGE}")
            flag2defense = {f: [] for f in base_model.allowed_flags}
            prev_flag = -1
            for flag, method in defense:
                if flag not in base_model.allowed_flags:
                    warnings.warn(
                        "Unsupported input-level flag; ignoring the defense")
                    continue
                flag2defense[flag].append(method)
                if order == SEQUENTIAL and flag < prev_flag:
                    warnings.warn("sequential defenses given out of flag "
                                  "order; re-ranged by flag")
                prev_flag = max(prev_flag, flag)
            self.flag2defense = flag2defense

    @property
    def num_defenses(self):
        return len(self.defense) if self.defense else 0

    @property
    def fast_path(self):
        return self.base_model.fast_path

    def fast_context(self, x, shard=None):
        """None: the fast path under a defense has no per-run context."""
        return None

    def _defend(self, defense, xx, rng):
        return defense(xx, draw=self.draw_fn if self.draw_fn is not None
                       else generator_draw(rng))

    # ------------------------------------------------------------------
    def process_sequential(self, x, rng=None):
        """Walk the feature ladder, applying each defense at its flag level
        (reference defended_model.py:46-63).  Returns the features at the
        base model's top flag, and that flag."""
        xx = x
        flags = sorted(self.flag2defense)
        for flag in flags:
            if flag == 0:
                xx = x
            elif flag == 1:
                xx = self.base_model.compute_feat(xx, flag=1)
            else:
                xx = self.base_model.comput_feat_from_feat(
                    xx, ori_flag=flag - 1, des_flag=flag)
            for defense in self.flag2defense[flag]:
                xx = self._defend(defense, xx, rng)
        return xx, flags[-1]

    # ------------------------------------------------------------------
    def embedding(self, x, rng=None, flag=0, fast=False, fast_ctx=None):
        if self.defense is None:
            return self.base_model.embedding(x, flag=0, rng=rng, fast=fast)
        if self.order == SEQUENTIAL:
            xx, top = self.process_sequential(x, rng=rng)
            return self.base_model.embedding(xx, flag=top, fast=fast)
        return self._average(x, rng, want="emb")

    def forward(self, x, return_emb=False, enroll_embs=None, rng=None,
                flag=0, fast=False, fast_ctx=None):
        if self.defense is None:
            return self.base_model.forward(x, flag=0, return_emb=return_emb,
                                           enroll_embs=enroll_embs, rng=rng,
                                           fast=fast)
        if self.order == SEQUENTIAL:
            xx, top = self.process_sequential(x, rng=rng)
            return self.base_model.forward(xx, flag=top,
                                           return_emb=return_emb,
                                           enroll_embs=enroll_embs,
                                           fast=fast)
        scores, emb = self._average(x, rng, want="both",
                                    enroll_embs=enroll_embs)
        return (scores, emb) if return_emb else scores

    def score(self, x, enroll_embs=None, rng=None, flag=0, fast=False,
              fast_ctx=None):
        return self.forward(x, enroll_embs=enroll_embs, rng=rng, fast=fast)

    def make_decision(self, x, enroll_embs=None, rng=None, flag=0,
                      fast=False):
        scores = self.score(x, enroll_embs=enroll_embs, rng=rng, fast=fast)
        return decide(scores, self.base_model.threshold)

    # ------------------------------------------------------------------
    def _average(self, x, rng, want="both", enroll_embs=None):
        """Ensemble-average composition (reference defended_model.py:
        107-126): each defense runs on the *clean* features at its flag
        level; scores and embeddings are averaged."""
        scores_acc, emb_acc, n = None, None, 0
        for flag in sorted(self.flag2defense):
            defenses = self.flag2defense[flag]
            if not defenses:
                continue
            xx = x if flag == 0 else self.base_model.compute_feat(x,
                                                                  flag=flag)
            for defense in defenses:
                scores, emb = self.base_model.forward(
                    self._defend(defense, xx, rng), flag=flag,
                    return_emb=True, enroll_embs=enroll_embs)
                scores_acc = scores if scores_acc is None else (scores_acc
                                                                + scores)
                emb_acc = emb if emb_acc is None else emb_acc + emb
                n += 1
        scores_acc = scores_acc / n
        emb_acc = emb_acc / n
        if want == "emb":
            return emb_acc
        return scores_acc, emb_acc
