"""Plain PGD (Madry et al.) as SpeakerGuard's attack/PGD.py runs it for an
untargeted close-set (CSI) attack with the cross-entropy loss:

    lower = max(x - eps, -1)     upper = min(x + eps, 1)
    x_0 = x
    x_{k+1} = clip(x_k + step * sign(grad_x CE(scores(x_k), y)), lower, upper)
    success = argmax scores(x_K) != y

with the front end's dither of iteration k drawn by ``dither(k)`` (the
final evaluation is iteration K).  ``score_fn(wav, dither) -> (B, S)`` is
a plain reference model's ``scores``; ``grad_fn``, of the same form,
scores the iterations where the attack's gradient path is a restricted
model (the frozen top-K components of iv-PLDA's fast path)."""

import torch


def bounds(x, eps):
    return torch.clamp(x - eps, min=-1.0), torch.clamp(x + eps, max=1.0)


def cross_entropy(scores, y):
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(1, y[:, None].long())[:, 0]


def attack(score_fn, x, y, eps, step, iters, dither, grad_fn=None):
    """-> (adversarial waves, final scores, success (B,) bool)."""
    grad_fn = grad_fn or score_fn
    lower, upper = bounds(x, eps)
    xx = x.clone()
    for k in range(iters):
        xx.requires_grad_(True)
        with torch.enable_grad():
            loss = cross_entropy(grad_fn(xx, dither(k)), y).sum()
            (grad,) = torch.autograd.grad(loss, xx)
        xx = torch.clamp(xx.detach() + step * torch.sign(grad), lower, upper)
    with torch.no_grad():
        scores = score_fn(xx, dither(iters))
    return xx, scores, scores.argmax(-1) != y
