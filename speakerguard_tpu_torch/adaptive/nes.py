"""NES gradient estimation (natural evolution strategies), batched.

Port of speakerguard_tpu/adaptive/nes.py (reference adaptive_attack/NES.py):
antithetic Gaussian sampling with the unperturbed point prepended, so that
the adversarial loss and score come with the estimate; the sample axis is
folded into the model batch.  The caller draws the Gaussian noise and
passes it in.

grad = E[loss(x + sigma*u) * u] / sigma, u ~ N(0, I) antithetic.
"""

import torch

from speakerguard_tpu_torch.attacks.losses import majority_vote


def sample_chunks(s1: int, samples_per_draw: int, samples_batch=None):
    """The sizes of the groups in which the ``s1`` = S + 1 evaluation points
    go through the model.  ``samples_batch`` is the reference's
    samples_per_draw_batch_size (NES.py:17-18), a budget of DRAWN samples:
    it chunks only when below ``samples_per_draw``, so the prepended
    unperturbed point never trips it.  The count of chunks comes from the
    budget, their sizes are balanced (s1 = 51, budget 25 -> 17, 17, 17).
    The JAX package pads the last chunk to the common size with junk lanes
    for ``lax.map``; here it is evaluated at its own size."""
    if samples_batch is None or samples_batch >= samples_per_draw:
        return [s1]
    n_chunks = -(-s1 // samples_batch)
    chunk = -(-s1 // n_chunks)
    return [min(chunk, s1 - i * chunk) for i in range(n_chunks)]


def nes_grad(eot_fn, x, y, noise, *, samples_per_draw: int, sigma: float,
             num_classes: int, rng=None, samples_batch: int = None):
    """x: (B, L); y: (B,); noise: (samples_per_draw // 2, B, L) standard
    Gaussian draws; eot_fn = adaptive.eot.eot_no_grad(...) closure, called
    with ``rng`` (a torch.Generator or None).

    Returns (mean_loss (B,), grad (B, L), adver_loss (B,), adver_score
    (B, S), predict (B,)) matching reference NES.forward's quintuple.

    The evaluation points x + sigma * [0, noise, -noise] go through the
    model in the groups of ``sample_chunks``: lanes are independent, so the
    grouping never changes a value.  Runs under ``torch.no_grad()``."""
    b, length = x.shape
    half = samples_per_draw // 2
    if tuple(noise.shape) != (half, b, length):
        raise ValueError(f"noise {tuple(noise.shape)}, expected "
                         f"{(half, b, length)}")
    with torch.no_grad():
        noise = torch.cat([torch.zeros_like(x)[None], noise, -noise])
        s1 = noise.shape[0]
        scores, loss, decisions = [], [], []
        start = 0
        for size in sample_chunks(s1, samples_per_draw, samples_batch):
            ex = (x[None] + sigma * noise[start:start + size]).reshape(
                size * b, length)
            ey = y.repeat(size)
            s, lo, d = eot_fn(ex, ey, rng)
            scores.append(s)
            loss.append(lo)
            decisions.append(d)
            start += size
        scores = torch.cat(scores).reshape(s1, b, -1)
        loss = torch.cat(loss).reshape(s1, b)
        # decisions: (E, S1*B) -> majority over the EOT axis -> (S1, B)
        predict = majority_vote(torch.cat(decisions, dim=1),
                                num_classes).reshape(s1, b)
        sample_loss = loss[1:]                                 # (S, B)
        grad = torch.mean(sample_loss[..., None] * noise[1:], dim=0) / sigma
        mean_loss = torch.mean(sample_loss, dim=0)
    return mean_loss, grad, loss[0], scores[0], predict[0]
