"""Carlini-Wagner L2 attack.

Port of speakerguard_tpu/attacks/cw2.py (reference attack/CW2.py): tanh box
reparameterisation, Adam on the modifier, loss = c * margin + ||delta||^2, a
binary search over c, early stop on a loss plateau and per-sample best
tracking.  The JAX package's while-of-scan-chunks is a Python loop here.
The per-sample bests stay on the device; the host reads the loss at the
early-stop checks and the (B,) decisions once per binary-search step.

Under ``mesh=`` (attacks/base.py) the early-stop check reads the global
batch's mean loss, so every rank stops together, and ``consts`` is the
global batch's.
"""

import numpy as np
import torch

from speakerguard_tpu_torch.attacks.base import (Attack, make_generator,
                                                 normalize_wav_input)
from speakerguard_tpu_torch.attacks.losses import margin_loss
from speakerguard_tpu_torch.models.base import decide
from speakerguard_tpu_torch.optim import adam_update

ATANH_CLIP = 0.999999


def _merge_best(step_best, global_best):
    """Per-sample min-L2 merge of one binary-search step's best (l2,
    decision, audio) into the running global best."""
    s_l2, s_score, s_x = step_best
    g_l2, g_score, g_x = global_best
    improved = s_l2 < g_l2
    return (torch.where(improved, s_l2, g_l2),
            torch.where(improved, s_score, g_score),
            torch.where(improved[:, None], s_x, g_x))


class CW2(Attack):

    def __init__(self, model, task="CSI", targeted=False, confidence=0.0,
                 initial_const=1e-3, binary_search_steps=9, max_iter=10000,
                 stop_early=True, stop_early_iter=1000, lr=1e-2,
                 batch_size=None, fast=False, fast_topk=False, mesh=None):
        # batch_size: memory knob chunking the input like the reference's
        # attack() loop; None = the whole input in one batch.
        # fast: the inner loop scores through the model's fast
        # attack-gradient path (the JAX package's SG_CW2_FAST=1); the
        # returned audio is re-scored on the exact path, so reported
        # success is always exact.  fast_topk: with fast, also use the
        # model's frozen top-K selection (SG_CW2_TOPK=1).  It stays off by
        # default: CW2's L2 perturbations leave the ball around the clean
        # input in which the frozen selection is faithful.
        self.batch_size = batch_size
        self.mesh = mesh
        self.model = model
        self.task = task
        self.targeted = targeted
        self.confidence = confidence
        self.initial_const = initial_const
        self.binary_search_steps = binary_search_steps
        self.max_iter = max_iter
        self.stop_early = stop_early
        self.stop_early_iter = stop_early_iter
        self.lr = lr
        self.fast = fast
        self.fast_topk = fast_topk
        # the per-sample consts after the last attack's binary search, and
        # those of its chunks so far
        self.consts = None
        self._consts = []

        self.threshold = None
        if task in ("SV", "OSI"):
            self.threshold = model.threshold

    def _loss1(self, scores, y):
        return margin_loss(scores, y, task=self.task, targeted=self.targeted,
                           confidence=self.confidence,
                           threshold=self.threshold, clip_max=True)

    def objective(self, modifier, x, x_atanh, y, const, gen=None,
                  ctx=None):
        """sum(const * l1 + l2) at ``modifier``, and (l1, l2, scores,
        audio): l1 the clipped margin loss, l2 the squared L2 distance of
        the audio tanh(modifier + x_atanh) from ``x``."""
        input_x = torch.tanh(modifier + x_atanh)
        scores = self.model.score(input_x, rng=self._row_rng(gen),
                                  fast=self.fast, fast_ctx=ctx)
        l1 = self._loss1(scores, y)
        l2 = torch.sum(torch.square(input_x - x), dim=-1)
        return torch.sum(const * l1 + l2), (l1, l2, scores, input_x)

    def _inner(self, x, y, const, gen):
        """One binary-search step: Adam on the modifier for max_iter steps
        over max_iter + 1 evaluations (the last one does not step).
        Returns the step's per-sample best (l2, decision, audio)."""
        model = self.model
        b = x.shape[0]
        x_atanh = torch.atanh(x * ATANH_CLIP)
        ctx = (model.fast_context(x, shard=self._shard)
               if self.fast and self.fast_topk else None)
        modifier = torch.zeros_like(x)
        mu, nu = torch.zeros_like(x), torch.zeros_like(x)
        best = (torch.full((b,), float("inf"), device=x.device),
                torch.full((b,), -2, dtype=torch.int32, device=x.device), x)
        prev_loss = torch.full((), float("inf"), device=x.device)
        for n_iter in range(self.max_iter + 1):
            m = modifier.detach().requires_grad_(True)
            with torch.enable_grad():
                total, (l1, l2, scores, input_x) = self.objective(
                    m, x, x_atanh, y, const, gen, ctx)
                (grad,) = torch.autograd.grad(total, m)
            input_x, l1, l2 = input_x.detach(), l1.detach(), l2.detach()
            decisions, _ = decide(scores.detach(), model.threshold)
            if n_iter < self.max_iter:
                update, mu, nu = adam_update(grad, mu, nu, n_iter + 1,
                                             self.lr)
                modifier = modifier + update
            # the bests use this evaluation's audio, before the step
            better = (l1 <= 0) & (l2 < best[0])
            best = (torch.where(better, l2, best[0]),
                    torch.where(better, decisions, best[1]),
                    torch.where(better[:, None], input_x, best[2]))
            if self.stop_early and n_iter % self.stop_early_iter == 0:
                loss_mean = self._mean(const * l1 + l2)
                if bool(loss_mean > 0.9999 * prev_loss):
                    break
                prev_loss = loss_mean
        return best

    def attack_batch(self, x, y, gen):
        b = x.shape[0]
        const = np.full(b, self.initial_const, np.float64)
        lower_bound = np.zeros(b)
        upper_bound = np.full(b, 1e10)
        global_best = (torch.full((b,), float("inf"), device=x.device),
                       torch.full((b,), -2, dtype=torch.int32,
                                  device=x.device), x)
        for _ in range(self.binary_search_steps):
            step_best = self._inner(
                x, y, torch.tensor(const, dtype=torch.float32,
                                   device=x.device), gen)
            global_best = _merge_best(step_best, global_best)
            hit = step_best[1].cpu().numpy() != -2
            for j in range(b):
                if hit[j]:  # succeeded at this c
                    upper_bound[j] = min(upper_bound[j], const[j])
                    if upper_bound[j] < 1e9:
                        const[j] = (lower_bound[j] + upper_bound[j]) / 2
                else:
                    lower_bound[j] = max(lower_bound[j], const[j])
                    if upper_bound[j] < 1e9:
                        const[j] = (lower_bound[j] + upper_bound[j]) / 2
                    else:
                        const[j] *= 10
        self._consts.append(self._gather_np(const, x.device))

        _, global_score, global_x = global_best
        success = (global_score != -2).tolist()
        if self.fast:
            # the fast loop's scores approximate the exact ones: re-score
            # the returned audio on the exact path, without dither
            with torch.no_grad():
                l1 = self._loss1(self.model.score(global_x), y).tolist()
            success = [s and v <= 0 for s, v in zip(success, l1)]
        return global_x, success

    def attack(self, x, y, rng=None):
        """x: (B, L) | (B, 1, L) | (L,) scale-domain audio; y: (B,) labels;
        rng: torch.Generator, int seed or None (it draws the dither).
        Returns (adversarial audio shaped like x, per-sample success list);
        ``self.consts`` then holds the per-sample consts."""
        dev = self.model.device
        x, restore = normalize_wav_input(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        gen = make_generator(rng, dev)
        self._consts = []
        adver, success = self.run_batched(self.attack_batch, x, y, gen,
                                          self.batch_size)
        self.consts = np.concatenate(self._consts)
        return restore(adver), success
