"""FAKEBOB — black-box score-based attack (IEEE S&P'21).

Port of speakerguard_tpu/attacks/fakebob.py (reference attack/FAKEBOB.py):
NES gradient estimation, momentum, a per-sample plateau learning-rate decay
and early stop.  Solved samples are inactive lanes, not rebuilt tensors;
the JAX package's while-loop over scan chunks is a Python loop here, one
NES body per pass, which reads on the host whether any lane is still
active.  Every NES forward runs under ``torch.no_grad()``.

``fast`` routes the NES sample forwards through the model's fast path with
exact-verified lane retirement and an exact re-evaluation of the returned
audio; threshold estimation always stays on the exact path, since its
accept/exceed exits compare raw scores against candidate thresholds.

Also implements the SV/OSI decision-threshold estimation
(FAKEBOB.py:210-295): a host loop over candidate thresholds.

Under ``mesh=`` (attacks/base.py) ``noise_fn`` is asked for the global
chunk's (S/2, B, L) draw, the loop runs while any lane of the global batch
is active and the exact guard runs whenever a lane of it crosses, so the
ranks step together; threshold estimation is not sharded.
"""

import numpy as np
import torch

from speakerguard_tpu_torch.adaptive.eot import eot_no_grad
# the module, not its function: adaptive/nes.py imports attacks/losses.py,
# whose package imports this module
from speakerguard_tpu_torch.adaptive import nes
from speakerguard_tpu_torch.attacks.base import (Attack, make_generator,
                                                 normalize_wav_input)
from speakerguard_tpu_torch.attacks.losses import margin_loss


def plateau_decay(ring, count, lr, loss, plateau_length, plateau_drop,
                  min_lr):
    """One step of the per-sample plateau ring buffer: push ``loss`` (B,)
    into ``ring`` (B, plateau_length); once the ring is full and its newest
    loss exceeds its oldest, divide ``lr`` by ``plateau_drop`` (floored at
    ``min_lr``) and restart the count.  Returns (ring, count, lr,
    trigger)."""
    ring = torch.cat([ring[:, 1:], loss[:, None]], dim=1)
    count = torch.clamp(count + 1, max=plateau_length)
    trigger = (count == plateau_length) & (ring[:, -1] > ring[:, 0])
    lr = torch.where(trigger, torch.clamp(lr / plateau_drop, min=min_lr), lr)
    count = torch.where(trigger, torch.zeros_like(count), count)
    return ring, count, lr, trigger


class FAKEBOB(Attack):

    def __init__(self, model, threshold=None, task="CSI", targeted=False,
                 confidence=0.0, epsilon=0.002, max_iter=1000, max_lr=0.001,
                 min_lr=1e-6, samples_per_draw=50,
                 samples_per_draw_batch_size=50, sigma=0.001, momentum=0.9,
                 plateau_length=5, plateau_drop=2.0, stop_early=True,
                 stop_early_iter=100, batch_size=None, EOT_size=1, fast=True,
                 noise_fn=None, mesh=None):
        # batch_size: memory knob chunking the input like the reference's
        # attack() loop; None = the whole input in one batch.  The NES
        # samples chunk through samples_per_draw_batch_size.
        # fast: the attack loop's NES forwards score through the model's
        # fast path (the JAX package's SG_BLACKBOX_FAST, default "1"); it
        # composes with the model's own gate (score(fast=True) is exact
        # where model.fast_path is None).  A lane retires as found only
        # once the exact model confirms its loss < 0, and the returned
        # audio is re-scored on the exact path, so reported success is
        # always exact.
        # noise_fn(it, shape) -> the NES noise of iteration ``it``, a
        # standard Gaussian tensor of ``shape`` on the model's device; by
        # default torch.randn from the attack's generator, one draw per
        # iteration in order.
        self.batch_size = batch_size
        self.mesh = mesh
        self.model = model
        self.threshold = threshold
        self.task = task
        self.targeted = targeted
        self.confidence = confidence
        self.epsilon = epsilon
        self.max_iter = max_iter
        self.max_lr = max_lr
        self.min_lr = min_lr
        self.samples_per_draw = samples_per_draw
        self.samples_per_draw_batch_size = samples_per_draw_batch_size
        self.sigma = sigma
        self.momentum = momentum
        self.plateau_length = plateau_length
        self.plateau_drop = plateau_drop
        self.stop_early = stop_early
        self.stop_early_iter = stop_early_iter
        self.EOT_size = max(1, EOT_size)
        self.fast = fast
        self.noise_fn = noise_fn
        self.grad_sign = -1  # Margin loss
        # NES bodies and exact guard evaluations of the last attack (of its
        # last batch_size chunk); NES bodies of threshold estimation since
        # the last estimate_threshold began
        self.last_executed_iters = None
        self.last_guard_evals = None
        self.estimate_bodies = 0

    # ------------------------------------------------------------------
    def _loss_fn(self, threshold):
        def fn(scores, label):
            return margin_loss(scores, label, task=self.task,
                               targeted=self.targeted,
                               confidence=self.confidence,
                               threshold=threshold, clip_max=False)
        return fn

    def _eot_fn(self, threshold, **score_kw):
        model = self.model
        return eot_no_grad(lambda xx, g: model.score(xx, rng=g, **score_kw),
                           self._loss_fn(threshold), model.threshold,
                           self.EOT_size)

    def _noise_fn(self, gen):
        """noise(it, shape) with the batch along dim 1 of ``shape``: under
        a mesh, this rank's rows of the global draw."""
        fn = self.noise_fn
        if fn is None:
            dev = self.model.device

            def fn(it, shape):
                return torch.randn(shape, generator=gen, device=dev)
        return lambda it, shape: self._draw_rows(
            lambda s: fn(it, s), shape, dim=1)

    def _nes_step(self, x, y, eot_fn, noise, gen):
        num_classes = self.model.num_spks if self.model.num_spks else 1
        return nes.nes_grad(eot_fn, x, y, noise,
                            samples_per_draw=self.samples_per_draw,
                            sigma=self.sigma, num_classes=num_classes,
                            rng=self._row_rng(gen),
                            samples_batch=self.samples_per_draw_batch_size)

    def _bounds(self, x):
        return (torch.clamp(x - self.epsilon, min=-1.0),
                torch.clamp(x + self.epsilon, max=1.0))

    # ------------------------------------------------------------------
    def attack_batch(self, x0, y, gen):
        """The attack loop on one batch: (best audio, success list)."""
        model = self.model
        b, length = x0.shape
        shape = (self.samples_per_draw // 2, b, length)
        noise_fn = self._noise_fn(gen)
        lower, upper = self._bounds(x0)
        exact_fn = self._eot_fn(self.threshold)
        nes_fn = exact_fn
        if self.fast:
            # the fast context (iv-PLDA's frozen top-K selection) comes
            # from the clean input once, valid inside the epsilon ball
            nes_fn = self._eot_fn(self.threshold, fast=True,
                                  fast_ctx=model.fast_context(
                                      x0, shard=self._shard))
        dev = x0.device
        x, best_x = x0, x0
        prev_grad = torch.zeros_like(x0)
        lr = torch.full((b,), self.max_lr, device=dev)
        ring = torch.zeros((b, self.plateau_length), device=dev)
        count = torch.zeros((b,), dtype=torch.int32, device=dev)
        active = torch.ones((b,), dtype=torch.bool, device=dev)
        best_loss = torch.full((b,), float("inf"), device=dev)
        prev_loss = torch.full((b,), float("inf"), device=dev)
        it = guard_evals = 0
        with torch.no_grad():
            while it <= self.max_iter and self._any(active):
                loss, grad, adver_loss, _, _ = self._nes_step(
                    x, y, nes_fn, noise_fn(it, shape), gen)
                # the bests use the loss at this iteration's x, before the
                # step
                better = active & (adver_loss < best_loss)
                best_loss = torch.where(better, adver_loss, best_loss)
                best_x = torch.where(better[:, None], x, best_x)
                # retire found lanes (adver_loss < 0); under fast the exact
                # model must confirm, or a fast loss crossing 0 on a
                # marginal lane would lock in a failure.  The exact
                # evaluation runs only on iterations where some lane
                # crosses.
                drop = active & (adver_loss < 0)
                if self.fast and self._any(drop):
                    drop = drop & (exact_fn(x, y, self._row_rng(gen))[1] < 0)
                    guard_evals += 1
                active = active & ~drop

                grad = (self.momentum * prev_grad
                        + (1.0 - self.momentum) * grad)
                ring, count, lr, _ = plateau_decay(
                    ring, count, lr, loss, self.plateau_length,
                    self.plateau_drop, self.min_lr)
                stepped = torch.clamp(
                    x + self.grad_sign * lr[:, None] * torch.sign(grad),
                    lower, upper)
                x = torch.where(active[:, None], stepped, x)

                # early stop: drop lanes whose mean loss no longer falls
                if self.stop_early and it % self.stop_early_iter == 0:
                    active = active & ~(prev_loss * 0.9999 - loss < 0)
                    prev_loss = loss
                prev_grad = grad
                it += 1
            if self.fast:
                # success is decided on the exact path
                best_loss = exact_fn(best_x, y, self._row_rng(gen))[1]
        self.last_executed_iters = it
        self.last_guard_evals = guard_evals
        return best_x, (best_loss < 0).tolist()

    def attack(self, x, y, rng=None):
        """x: (B, L) | (B, 1, L) | (L,) scale-domain audio; y: (B,) labels;
        rng: torch.Generator, int seed or None (it draws the NES noise and
        the dither).  Returns (adversarial audio shaped like x, per-sample
        success list).  ``last_executed_iters`` then holds the NES bodies
        the loop ran; the JAX package's count also includes up to 7 masked
        bodies of its scan-chunk overshoot."""
        if self.task in ("SV", "OSI") and self.threshold is None:
            raise RuntimeError(
                f"black-box attack on {self.task} requires a threshold; "
                "call estimate_threshold first")
        dev = self.model.device
        x, restore = normalize_wav_input(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        gen = make_generator(rng, dev)
        adver, success = self.run_batched(self.attack_batch, x, y, gen,
                                          self.batch_size)
        return restore(adver), success

    # ------------------------------------------------------------------
    def estimate_threshold_run(self, x, step=0.1, rng=None):
        """Single-utterance threshold estimation (FAKEBOB.py:210-278) on the
        exact path.  x: (1, L), rejected by the model; returns the score at
        which the model first accepts it, or None when it is accepted
        already.  ``rng`` (default seed 1) draws the noise and dither.

        Candidate thresholds start 1 ``step`` of the clean score above it;
        the NES steps climb towards the candidate, and the candidate rises
        by the same delta whenever the score exceeds it without an accept.
        ``it`` advances only on committed steps, so the breaking
        iteration's noise is the next candidate's first.  Like the JAX
        loop, this one does not end while the model's threshold is out of
        reach inside epsilon."""
        model = self.model
        dev = model.device
        gen = make_generator(1 if rng is None else rng, dev)
        noise_fn = self._noise_fn(gen)
        with torch.no_grad():
            d, s = model.make_decision(x)
            if int(d[0]) != -1:
                return None  # already accepted: unusable
            y = torch.tensor([-1], device=dev)
            init_score = float(torch.max(s[0]))
            delta = abs(init_score * step)
            threshold = init_score + delta
            lower, upper = self._bounds(x)
            adver_x, grad = x, torch.zeros_like(x)
            shape = (self.samples_per_draw // 2, 1, x.shape[1])
            it, noise = 0, None
            # the host keeps lr as float32 and the ring, as the JAX loop's
            # carry does
            max_lr = np.float32(self.max_lr)
            lr, ring, count = max_lr, [0.0] * self.plateau_length, 0
            while True:
                if noise is None:
                    noise = noise_fn(it, shape)
                # the candidate is a float32 scalar, as in the JAX loop
                thr = float(np.float32(threshold))
                loss, g, _, adver_score, predict = self._nes_step(
                    adver_x, y, self._eot_fn(thr), noise, gen)
                self.estimate_bodies += 1
                score = float(torch.max(adver_score[0]))
                if int(predict[0]) != -1:
                    return score  # accepted: the threshold is found
                if score >= thr:
                    # the candidate is exceeded: raise it; lr and the
                    # ring restart, and this iteration's noise is reused
                    threshold += delta
                    lr, ring, count = max_lr, [0.0] * self.plateau_length, 0
                    continue
                g = self.momentum * grad + (1.0 - self.momentum) * g
                adver_x = torch.clamp(
                    adver_x + self.grad_sign * float(lr) * torch.sign(g),
                    lower, upper)
                grad = g
                ring = ring[1:] + [float(loss[0])]
                count = min(count + 1, self.plateau_length)
                if count == self.plateau_length and ring[-1] > ring[0]:
                    if lr > self.min_lr:
                        lr = np.maximum(lr / np.float32(self.plateau_drop),
                                        np.float32(self.min_lr))
                    count = 0
                it, noise = it + 1, None

    def estimate_threshold(self, x, step=0.1, rng=None):
        """x: (B, 1, L) or (B, L) candidate rejected utterances; sets
        self.threshold to the mean estimate over the usable ones
        (FAKEBOB.py:280-295) and returns it (None on CSI, or when none is
        usable).  With an int seed (or None) as ``rng``, each utterance's
        estimation starts from the same draws, as the JAX package's
        starts from the same key."""
        if self.task == "CSI":
            return None
        x, _ = normalize_wav_input(x, device=self.model.device)
        self.estimate_bodies = 0
        estimates = []
        for i in range(x.shape[0]):
            est = self.estimate_threshold_run(x[i:i + 1], step, rng)
            if est is not None:
                estimates.append(est)
        self.threshold = float(np.mean(estimates)) if estimates else None
        return self.threshold
