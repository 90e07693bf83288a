"""SirenAttack — the black-box particle swarm optimisation attack.

Port of speakerguard_tpu/attacks/siren.py (reference attack/SirenAttack.py).
The particle axis is folded into the model batch: one evaluation scores all
B x P particles.  The epoch loop and the inner loop are Python loops over
device state, with per-lane active masks where the reference rebuilds its
tensors; the JAX package's ``lax.while_loop`` over epochs and ``lax.scan``
over iterations become these loops, whose host reads decide the aborts.

Kept as the JAX package has them: inertia annealed from ``w_init`` to
``w_end``, the cognitive and social terms ``c1``, ``c2`` with fresh
``r = U + 1e-5`` each iteration, velocities drawn fresh at each epoch in
+-|upper - lower|, the re-init that keeps each lane's best particle, the
distortion bounds, the inner plateau abort every ``abort_early_iter`` and
the epoch plateau abort every ``abort_early_epoch``, and the
``max_iter + 1`` evaluations of an epoch, the last of which takes no step.

``fast`` is the JAX package's SG_BLACKBOX_FAST (on by default there): the
particle evaluations score through the model's fast path, with the fast
context of the clean input.  A lane retires as found only once the exact
model confirms its gbest loss < 0, and the returned audio is re-scored on
the exact path, so reported success is exact.  The guard runs, as in the
JAX package, on every iteration where some active lane's gbest is below
0, also after the inner loop stopped stepping, and again on each later
iteration while the exact model disagrees; ``last_guard_evals`` counts its
exact forwards.  An iteration where no lane would take its evaluation's
result (the inner loop stopped, or no lane active) skips the B x P
evaluation, which would change nothing; the guard still runs there.

Randomness: ``draw_fn(kind, epoch, it, shape)`` gives the uniform draws
already scaled to their bounds: ``"init"`` (B, P, L) in [lower, upper] at
epoch 0, ``"reinit"`` (B, P - 1, L) in [lower, upper] at each later epoch,
``"velocity"`` (B, P, L) in +-|upper - lower| at each epoch, ``"r1"`` and
``"r2"`` (B, P, L) in [0, 1) at each iteration that steps (``it`` is None
for the epoch's draws).  By default they come from the attack's
``torch.Generator``; the CPU tests pass JAX's.

Under ``mesh=`` (attacks/base.py) ``draw_fn`` is asked for the global
chunk's draws, and the aborts, the guard and the loops' continuation read
the global batch (its any, its mean gbest), so the ranks step together.
"""

import numpy as np
import torch

from speakerguard_tpu_torch.adaptive.eot import eot_no_grad
from speakerguard_tpu_torch.attacks.base import (Attack, make_generator,
                                                 normalize_wav_input)
from speakerguard_tpu_torch.attacks.losses import margin_loss


def generator_draws(rand, lower, upper):
    """The default ``draw_fn``: uniform draws ``rand(shape)`` scaled to the
    bounds of each kind (``lower``, ``upper``: (B, L))."""
    v_upper = torch.abs(upper - lower)
    lo = {"init": lower, "reinit": lower, "velocity": -v_upper}
    hi = {"init": upper, "reinit": upper, "velocity": v_upper}

    def draw(kind, epoch, it, shape):
        u = rand(shape)
        if kind in ("r1", "r2"):
            return u
        a, b = lo[kind][:, None, :], hi[kind][:, None, :]
        return torch.maximum(a, u * (b - a) + a)
    return draw


class SirenAttack(Attack):

    def __init__(self, model, threshold=None, task="CSI", targeted=False,
                 confidence=0.0, epsilon=0.002, max_epoch=300, max_iter=30,
                 c1=1.4961, c2=1.4961, n_particles=25, w_init=0.9,
                 w_end=0.1, batch_size=None, EOT_size=1, abort_early=True,
                 abort_early_iter=10, abort_early_epoch=10, fast=True,
                 draw_fn=None, mesh=None):
        # batch_size: memory knob chunking the utterance axis (None = the
        # whole input); the particle axis multiplies memory by n_particles
        self.batch_size = batch_size
        self.mesh = mesh
        self.model = model
        self.threshold = threshold
        self.task = task
        self.targeted = targeted
        self.confidence = confidence
        self.epsilon = epsilon
        self.max_epoch = max_epoch
        self.max_iter = max_iter
        self.c1, self.c2 = c1, c2
        self.n_particles = n_particles
        self.w_init, self.w_end = w_init, w_end
        self.EOT_size = max(1, EOT_size)
        self.abort_early = abort_early
        self.abort_early_iter = abort_early_iter
        self.abort_early_epoch = abort_early_epoch
        self.fast = fast
        self.draw_fn = draw_fn
        # of the last attack (of its last batch_size chunk): the epochs
        # run, the B x P particle evaluations and the guard's exact
        # forwards
        self.last_executed_epochs = None
        self.last_particle_evals = None
        self.last_guard_evals = None

    def _loss_fn(self, scores, label):
        return margin_loss(scores, label, task=self.task,
                           targeted=self.targeted,
                           confidence=self.confidence,
                           threshold=self.threshold, clip_max=False)

    def _eot_fn(self, **score_kw):
        model = self.model
        return eot_no_grad(lambda xx, g: model.score(xx, rng=g, **score_kw),
                           self._loss_fn, model.threshold, self.EOT_size)

    def _inertia(self, it):
        """w at iteration ``it``, in float32 as the JAX loop computes it."""
        f = np.float32
        return float(f(f(self.w_init - self.w_end) * f(self.max_iter - it - 1))
                     / f(self.max_iter) + f(self.w_end))

    def _epoch(self, x, y, lower, upper, state, epoch, eot_fn, exact_fn,
               draw, gen):
        """One epoch of max_iter + 1 evaluations; updates ``state`` (the
        pbest/gbest tensors and ``active``) in place.  The JAX loop also
        carries each lane's predicted label at its gbest, which nothing
        reads; the port does not."""
        b, length = x.shape
        p = self.n_particles
        velocities = draw("velocity", epoch, None, (b, p, length))
        locations = state["pbest_locations"]
        pbest_locations, pbests = state["pbest_locations"], state["pbests"]
        gbest_loc, gbests = state["gbest_loc"], state["gbests"]
        active = state["active"]
        prev_gbest, cont = gbests, True
        y_rep = y.repeat_interleave(p)
        for it in range(self.max_iter + 1):
            do = active if cont else torch.zeros_like(active)
            any_do = cont and self._any(active)
            if any_do:
                eval_x = (locations + x[:, None, :]).reshape(b * p, length)
                loss = eot_fn(eval_x, y_rep,
                              self._row_rng(gen, "batch"))[1].reshape(b, p)
                self.last_particle_evals += 1
                upd = do[:, None] & (loss < pbests)
                pbests = torch.where(upd, loss, pbests)
                pbest_locations = torch.where(upd[..., None], locations,
                                              pbest_locations)
                # argmin takes the first of equal values, as jnp.argmin
                best_idx = torch.argmin(pbests, dim=1)
                rows = torch.arange(b, device=x.device)
                best_val = pbests[rows, best_idx]
                better = do & (best_val < gbests)
                gbests = torch.where(better, best_val, gbests)
                gbest_loc = torch.where(better[:, None],
                                        pbest_locations[rows, best_idx],
                                        gbest_loc)

            # inner early abort on a plateau of the mean gbest
            if self.abort_early and (it + 1) % self.abort_early_iter == 0:
                if bool(self._mean(gbests)
                        > 0.9999 * self._mean(prev_gbest)):
                    cont = False
                prev_gbest = gbests

            newly = active & (gbests < 0)
            if exact_fn is not None and self._any(newly):
                newly = newly & (exact_fn(gbest_loc + x, y,
                                          self._row_rng(gen))[1] < 0)
                self.last_guard_evals += 1
            active = active & ~newly
            cont = cont and self._any(active)

            if any_do and it < self.max_iter:
                w = self._inertia(it)
                r1 = draw("r1", epoch, it, (b, p, length)) + 1e-5
                r2 = draw("r2", epoch, it, (b, p, length)) + 1e-5
                velocities_new = (w * velocities
                                  + self.c1 * r1 * (pbest_locations
                                                    - locations)
                                  + self.c2 * r2 * (gbest_loc[:, None, :]
                                                    - locations))
                locations_new = torch.clamp(locations + velocities_new,
                                            lower[:, None, :],
                                            upper[:, None, :])
                velocities = torch.where(do[:, None, None], velocities_new,
                                         velocities)
                locations = torch.where(do[:, None, None], locations_new,
                                        locations)
        state.update(pbest_locations=pbest_locations, pbests=pbests,
                     gbest_loc=gbest_loc, gbests=gbests, active=active)

    def attack_batch(self, x, y, gen):
        """The attack on one batch: (adversarial audio, success list)."""
        model = self.model
        b, length = x.shape
        p = self.n_particles
        dev = x.device
        # distortion bounds (SirenAttack.py:251-252)
        lower = torch.clamp(-1.0 - x, min=-self.epsilon)
        upper = torch.clamp(1.0 - x, max=self.epsilon)
        if self.draw_fn is not None:
            def draw(kind, epoch, it, shape):
                return self._draw_rows(
                    lambda s: self.draw_fn(kind, epoch, it, s), shape)
        else:
            draw = generator_draws(
                lambda shape: self._draw_rows(
                    lambda s: torch.rand(s, generator=gen, device=dev),
                    shape), lower, upper)
        exact_fn = self._eot_fn()
        eot_fn, guard = exact_fn, None
        if self.fast:
            # the fast context (iv-PLDA's frozen top-K selection) comes
            # from the clean input once, valid inside the epsilon ball
            eot_fn = self._eot_fn(fast=True,
                                  fast_ctx=model.fast_context(
                                      x, shard=self._shard))
            guard = exact_fn
        inf = torch.full((b,), float("inf"), device=dev)
        state = dict(pbest_locations=None, pbests=None,
                     gbest_loc=torch.zeros_like(x), gbests=inf,
                     active=torch.ones((b,), dtype=torch.bool, device=dev))
        prev_gbest_epoch = inf
        self.last_particle_evals = self.last_guard_evals = 0
        epoch, cont = 0, True
        with torch.no_grad():
            while (epoch < self.max_epoch and cont
                   and self._any(state["active"])):
                if epoch == 0:
                    state["pbest_locations"] = draw("init", epoch, None,
                                                    (b, p, length))
                    state["pbests"] = torch.full((b, p), float("inf"),
                                                 device=dev)
                else:
                    # keep each lane's best particle, draw the others anew
                    best_idx = torch.argmin(state["pbests"], dim=1)
                    rows = torch.arange(b, device=dev)
                    best_val = state["pbests"][rows, best_idx]
                    best_loc = state["pbest_locations"][rows, best_idx]
                    fresh = draw("reinit", epoch, None, (b, p - 1, length))
                    state["pbest_locations"] = torch.cat(
                        [best_loc[:, None], fresh], dim=1)
                    state["pbests"] = torch.cat(
                        [best_val[:, None],
                         torch.full((b, p - 1), float("inf"), device=dev)],
                        dim=1)
                self._epoch(x, y, lower, upper, state, epoch, eot_fn, guard,
                            draw, gen)
                if (self.abort_early
                        and (epoch + 1) % self.abort_early_epoch == 0):
                    cont = not bool(self._mean(state["gbests"])
                                    > 0.9999 * self._mean(prev_gbest_epoch))
                    prev_gbest_epoch = state["gbests"]
                epoch += 1
            self.last_executed_epochs = epoch
            adver = state["gbest_loc"] + x
            gbests = state["gbests"]
            if self.fast:
                # success is decided on the exact path
                gbests = exact_fn(adver, y, self._row_rng(gen))[1]
        return adver, (gbests < 0).tolist()

    def attack(self, x, y, rng=None):
        """x: (B, L) | (B, 1, L) | (L,) scale-domain audio; y: (B,) labels;
        rng: torch.Generator, int seed or None (the particle draws, unless
        ``draw_fn`` gives them, and the dither).  Returns (adversarial audio
        shaped like x, per-sample success list)."""
        if self.task in ("SV", "OSI") and self.threshold is None:
            raise RuntimeError(
                f"black-box attack on {self.task} requires a threshold; "
                "estimate it with FAKEBOB")
        dev = self.model.device
        x, restore = normalize_wav_input(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        gen = make_generator(rng, dev)
        adver, success = self.run_batched(self.attack_batch, x, y, gen,
                                          self.batch_size)
        return restore(adver), success
