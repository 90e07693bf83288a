"""BPDA — Backward-Pass Differentiable Approximation as an autograd Function.

Port of speakerguard_tpu/adaptive/bpda.py (reference adaptive_attack/BPDA.py):
the forward runs the (possibly non-differentiable) original function under
``no_grad`` and saves its input; the backward runs the substitute on that
input under ``enable_grad`` and returns its vector-Jacobian product with the
incoming gradient.

Used to make QT/BDR attackable (reference defense/time_domain.py:44 wraps
QT_Non_Diff with an identity substitute: the straight-through estimator).
"""

import torch


def _identity(x, *args):
    return x


class _BPDA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ori_f, sub_f, *args):
        ctx.sub_f, ctx.args = sub_f, args
        ctx.save_for_backward(x)
        with torch.no_grad():
            return ori_f(x, *args)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(ctx.sub_f(xx, *ctx.args), xx, g)
        return (gx, None, None) + (None,) * len(ctx.args)


def bpda(ori_f, sub_f=None):
    """Returns g(x, *args): ``ori_f(x, *args)`` forward, differentiable in
    x through ``sub_f``'s VJP.  ``sub_f`` defaults to identity
    (straight-through)."""
    sub_f = _identity if sub_f is None else sub_f

    def f(x, *args):
        return _BPDA.apply(x, ori_f, sub_f, *args)

    return f
