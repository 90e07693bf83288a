"""EOT — Expectation over Transformation, as a loop over repeats.

Port of speakerguard_tpu/adaptive/eot.py (reference adaptive_attack/EOT.py).
Each repeat scores the batch with its own randomness (the dither drawn from
the shared ``torch.Generator``), takes the input gradient of the summed
per-sample loss, and the repeats' scores, losses and gradients are averaged;
the per-repeat decisions are returned for majority voting.

The `score_fn(x, rng) -> (B, S)` closure is the only model contract.  The
``rng`` a run gets is handed to every repeat, or, when it is a list, its
``e``-th entry to repeat ``e`` (an attack's per-repeat dither draws).
"""

import torch

from speakerguard_tpu_torch.models.base import decide


def _repeat_rng(rng, e):
    return rng[e] if isinstance(rng, list) else rng


def eot(score_fn, loss_fn, threshold: float, eot_size: int = 1):
    """Returns fn(x, y, rng) -> (scores (B,S), loss (B,), grad like x,
    decisions (E, B)); means over the EOT repeats."""

    def run(x, y, rng):
        scores_all, loss_all, grad_all, dec_all = [], [], [], []
        for e in range(eot_size):
            xx = x.detach().requires_grad_(True)
            with torch.enable_grad():
                scores = score_fn(xx, _repeat_rng(rng, e))
                loss = loss_fn(scores, y)
                (grad,) = torch.autograd.grad(loss.sum(), xx)
            scores, loss = scores.detach(), loss.detach()
            scores_all.append(scores)
            loss_all.append(loss)
            grad_all.append(grad)
            dec_all.append(decide(scores, threshold)[0])
        return (torch.stack(scores_all).mean(0), torch.stack(loss_all).mean(0),
                torch.stack(grad_all).mean(0), torch.stack(dec_all))

    return run


def eot_no_grad(score_fn, loss_fn, threshold: float, eot_size: int = 1):
    """Score-only variant: fn(x, y, rng) -> (scores, loss, decisions)."""

    def run(x, y, rng):
        scores_all, loss_all, dec_all = [], [], []
        with torch.no_grad():
            for e in range(eot_size):
                scores = score_fn(x, _repeat_rng(rng, e))
                scores_all.append(scores)
                loss_all.append(loss_fn(scores, y))
                dec_all.append(decide(scores, threshold)[0])
        return (torch.stack(scores_all).mean(0), torch.stack(loss_all).mean(0),
                torch.stack(dec_all))

    return run
