"""White-box gradient attacks: FGSM, PGD, CW-inf — one iteration engine.

Port of speakerguard_tpu/attacks/gradient.py (reference attack/FGSM.py /
PGD.py / CWinf.py).  Each iteration takes an EOT-averaged value-and-grad and
the signed step + clip; the JAX package's ``lax.scan`` over iterations (and
over random restarts) is a Python loop here.  The iterations score through
the model's fast attack-gradient path (``fast=True`` with the restart's
``fast_context``, built once from the clean input); the final evaluation,
which alone decides success, is exact (reference FGSM.py:44-47).

Class relationships preserved: FGSM == PGD with max_iter=1, step=epsilon,
global clip bounds; CWinf == PGD with Margin loss forced.

Randomness: by default the attack's torch.Generator draws the restart's
init noise and the model's dither, in call order.  Two hooks let a caller
hand the draws in instead (the CPU tests pass the JAX package's, whose key
schedule is ``split(rng)`` -> (init key, loop key) per restart, the loop
key split into (max_iter + 1) x EOT_size dither keys):

  init_noise_fn(restart, shape)    the noise added to x at the start of
                                   restart ``restart``: uniform in
                                   [-epsilon, epsilon) (JAX's
                                   ``uniform(init_key, shape, -eps, eps)``).
  dither_fn(restart, it, e, shape) the frontend's standard normal dither of
                                   iteration ``it`` (``it == max_iter`` is
                                   the final evaluation) and EOT repeat
                                   ``e`` (JAX's ``normal(keys[it, e],
                                   frames.shape)``).

Each returns a float32 array or tensor of ``shape``.  The restart index is 0
without restarts.  FGSM and CWinf take them as attributes.  With
``batch_size`` chunking each chunk calls them again with the same indices.
``dither_fn`` reaches the base model's frontend; a defended model with
defenses has no dithered frontend and rejects it.  Under ``mesh=`` (see
attacks/base.py) both hooks are asked for the global chunk's draw, of
which the rank takes its rows, and the restarts' whole-batch success
rates are global.
"""

import torch

from speakerguard_tpu_torch.adaptive.eot import eot, eot_no_grad
from speakerguard_tpu_torch.attacks.base import (Attack, make_generator,
                                                 normalize_wav_input)
from speakerguard_tpu_torch.attacks.losses import (compare, majority_vote,
                                                   resolve_loss)


class PGD(Attack):

    def __init__(self, model, task="CSI", epsilon=0.002, step_size=0.0004,
                 max_iter=10, num_random_init=0, loss="Entropy",
                 targeted=False, batch_size=None, EOT_size=1,
                 init_noise_fn=None, dither_fn=None, mesh=None):
        # batch_size: optional memory knob chunking the input like the
        # reference's attack() loops; None = the whole input in one batch.
        # The EOT_size repeats run one after another (adaptive/eot.py).
        # init_noise_fn, dither_fn: the draw hooks (module docstring).
        # mesh: a DeviceMesh whose 'data' axis shards each chunk.
        if dither_fn is not None and getattr(model, "num_defenses", 0):
            raise ValueError("dither_fn: a defended model's frontend has no "
                             "dither")
        self.init_noise_fn = init_noise_fn
        self.dither_fn = dither_fn
        self.mesh = mesh
        self.batch_size = batch_size
        self.model = model
        self.task = task
        self.epsilon = epsilon
        self.step_size = step_size
        self.max_iter = max_iter
        self.num_random_init = num_random_init
        self.targeted = targeted
        self.EOT_size = max(1, EOT_size)

        self.threshold = None
        if task in ("SV", "OSI"):
            self.threshold = model.threshold
        self.loss_fn, self.grad_sign = resolve_loss(
            loss_name=loss, targeted=targeted, task=task,
            threshold=self.threshold, clip_max=False)

    def _bounds(self, x):
        lower = torch.clamp(x - self.epsilon, min=-1.0)
        upper = torch.clamp(x + self.epsilon, max=1.0)
        return lower, upper

    def _rngs(self, gen, restart, it):
        """What iteration ``it``'s EOT repeats draw their dither from: the
        generator, or one draw function each from ``dither_fn``."""
        if self.dither_fn is None:
            return self._row_rng(gen)
        return [self._row_rng(
                    lambda shape, e=e: self.dither_fn(restart, it, e, shape))
                for e in range(self.EOT_size)]

    def _init_noise(self, x, gen, restart):
        if self.init_noise_fn is None:
            noise = self._draw_rows(
                lambda shape: torch.rand(shape, generator=gen,
                                         device=x.device, dtype=x.dtype),
                x.shape)
            return (2.0 * noise - 1.0) * self.epsilon
        noise = torch.as_tensor(
            self._draw_rows(lambda shape: self.init_noise_fn(restart, shape),
                            x.shape), dtype=x.dtype, device=x.device)
        if noise.shape != x.shape:
            raise ValueError(f"init noise of shape {tuple(noise.shape)}, "
                             f"expected {tuple(x.shape)}")
        return noise

    def _single(self, x, y, gen, do_init_noise, restart=0):
        """One restart: bounds, optional init noise, the iterations, the
        exact final evaluation."""
        model = self.model
        # dither-free, once per restart
        ctx = model.fast_context(x, shard=self._shard)
        eot_run = eot(lambda xx, g: model.score(xx, rng=g, fast=True,
                                                fast_ctx=ctx),
                      self.loss_fn, model.threshold, self.EOT_size)
        eot_ng = eot_no_grad(lambda xx, g: model.score(xx, rng=g),
                             self.loss_fn, model.threshold)
        lower, upper = self._bounds(x)
        xx = x
        if do_init_noise:
            # the reference does NOT clip the init point (PGD.py:59-61)
            xx = x + self._init_noise(x, gen, restart)
        for it in range(self.max_iter):
            _, _, grad, _ = eot_run(xx, y, self._rngs(gen, restart, it))
            xx = xx + self.step_size * torch.sign(grad) * self.grad_sign
            xx = torch.clamp(xx, lower, upper)
        # the final evaluation draws as EOT repeat 0 of iteration max_iter
        scores, loss, decisions = eot_ng(xx, y,
                                         self._rngs(gen, restart,
                                                    self.max_iter))
        predict = majority_vote(decisions, scores.shape[-1])
        return xx, predict, loss

    def attack(self, x, y, rng=None):
        """x: (B, L) | (B, 1, L) | (L,) scale-domain audio; y: (B,) labels;
        rng: torch.Generator, int seed or None.
        Returns (adversarial audio shaped like x, per-sample success list)."""
        dev = self.model.device
        x, restore = normalize_wav_input(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        gen = make_generator(rng, dev)
        adver, success = self.run_batched(self._attack_whole, x, y, gen,
                                          self.batch_size)
        return restore(adver), success

    def _attack_whole(self, x, y, gen):
        if self.num_random_init > 1:
            # best whole-batch success rate over restarts; strict '>' keeps
            # the earliest restart on ties (reference PGD.py:54-77)
            best_rate, best_x, best_pred = -1.0, None, None
            for r in range(self.num_random_init):
                x_adv, predict, _ = self._single(x, y, gen, True, r)
                rate = float(self._mean(
                    compare(y, predict, self.targeted).float()))
                if rate > best_rate:
                    best_rate, best_x, best_pred = rate, x_adv, predict
            adver_x, predict = best_x, best_pred
        else:
            adver_x, predict, _ = self._single(x, y, gen,
                                               self.num_random_init > 0)
        return adver_x, self.compare(y, predict, self.targeted)


class FGSM(PGD):

    def __init__(self, model, task="CSI", epsilon=0.002, loss="Entropy",
                 targeted=False, batch_size=None, EOT_size=1, mesh=None):
        super().__init__(model, task=task, epsilon=epsilon,
                         step_size=epsilon, max_iter=1, num_random_init=0,
                         loss=loss, targeted=targeted, batch_size=batch_size,
                         EOT_size=EOT_size, mesh=mesh)

    def _bounds(self, x):
        # FGSM clips to the global audio range, not an epsilon ball
        # (reference FGSM.py:74-81)
        return torch.full_like(x, -1.0), torch.full_like(x, 1.0)


class CWinf(PGD):

    def __init__(self, model, task="CSI", epsilon=0.002, step_size=0.0004,
                 max_iter=10, num_random_init=0, loss="Margin",
                 targeted=False, batch_size=None, EOT_size=1, mesh=None):
        super().__init__(model, task=task, epsilon=epsilon,
                         step_size=step_size, max_iter=max_iter,
                         num_random_init=num_random_init, loss="Margin",
                         targeted=targeted, batch_size=batch_size,
                         EOT_size=EOT_size, mesh=mesh)
