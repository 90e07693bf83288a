"""ECAPA-TDNN's attentive statistics over time, and their kernel.

For logits L and activations m, both (B, T, C), with alpha = softmax over
t of L[b, :, c]:

    mu = sum_t alpha m,   var = sum_t alpha (m - mu)^2,
    sigma = sqrt(max(var, eps))

(the weighted mean and std of SpeechBrain's attentive statistics pooling,
the variance centred).  ``AttentiveStats`` is the pooling of the fast
path, an autograd Function of (L, m): on a CUDA tensor one launch of
``csrc/asp_pool.cu`` a direction (the source's header says how), on a CPU
tensor its plain version (``stats_fwd_plain``, ``stats_bwd_plain``).  Both
take L in float32 and give float32 statistics; the kernel takes m in bf16
and returns m's cotangent in bf16.  The backward, with dvar = gsigma / (2
sigma) where var >= eps (else 0) and dalpha_t = gmu m_t + dvar (m_t -
mu)^2:

    dL_t = alpha_t (dalpha_t - sum_s alpha_s dalpha_s)
    dm_t = alpha_t (gmu + 2 dvar (m_t - mu))

The exact path differentiates ``stats_fwd_plain`` with autograd.
"""

import torch

from speakerguard_tpu_torch.ops._build import (FLT, INT, PTR, KernelWrapper,
                                               Library)


def stats_fwd_plain(logits, m, eps):
    """-> (mu, sigma, lmax, lsum, var), each (B, C) float32: the
    statistics, and the logits' max and sum of exponentials over t and the
    variance that the backward reads."""
    x = m.float()
    lmax = logits.amax(dim=1)
    e = torch.exp(logits - lmax[:, None])
    lsum = e.sum(dim=1)
    alpha = e / lsum[:, None]
    mu = (alpha * x).sum(dim=1)
    var = (alpha * (x - mu[:, None]) ** 2).sum(dim=1)
    return mu, torch.sqrt(torch.clamp(var, min=eps)), lmax, lsum, var


def stats_bwd_plain(logits, m, eps, mu, sigma, lmax, lsum, var, gmu,
                    gsigma):
    """-> (the logits' cotangent, float32; m's, in m's dtype)."""
    x = m.float()
    alpha = torch.exp(logits - lmax[:, None]) / lsum[:, None]
    dv = torch.where(var >= eps, gsigma / (2.0 * sigma), 0.0)
    d = x - mu[:, None]
    dalpha = gmu[:, None] * x + dv[:, None] * d * d
    total = (alpha * dalpha).sum(dim=1)
    dl = alpha * (dalpha - total[:, None])
    dm = alpha * (gmu[:, None] + 2.0 * dv[:, None] * d)
    return dl, dm.to(m.dtype)


# The argument types of csrc/asp_pool.cu's C entry points, in order.
ARGTYPES = {
    # logits, m, b, t, c, eps, mu, sigma, lmax, lsum, var, stream
    "sg_asp_stats_fwd": [PTR, PTR, INT, INT, INT, FLT, PTR, PTR, PTR, PTR,
                         PTR, PTR],
    # logits, m, b, t, c, eps, mu, sigma, lmax, lsum, var, gmu, gsigma,
    # dlogits, dm, stream
    "sg_asp_stats_bwd": [PTR, PTR, INT, INT, INT, FLT, PTR, PTR, PTR, PTR,
                         PTR, PTR, PTR, PTR, PTR, PTR],
}
LIB = Library("asp_pool", ARGTYPES)


def _check(logits, m):
    if logits.dim() != 3 or logits.shape != m.shape:
        raise ValueError(f"logits and m of one (B, T, C) shape expected: "
                         f"{tuple(logits.shape)}, {tuple(m.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"float32 logits expected, not {logits.dtype}")
    if logits.device != m.device:
        raise ValueError(f"logits on {logits.device}, m on {m.device}")


class _AspStats(KernelWrapper):
    """``asp_stats.forward(logits, m, eps) -> (mu, sigma, lmax, lsum,
    var)`` and ``asp_stats.backward(logits, m, eps, mu, sigma, lmax, lsum,
    var, gmu, gsigma) -> (dlogits, dm)``; ``launches`` counts both
    directions' launches."""

    name = "asp_stats"
    lib = LIB

    def forward(self, logits, m, eps):
        _check(logits, m)
        if not self.route(m):
            return stats_fwd_plain(logits, m, eps)
        if m.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bf16 activations, not "
                            f"{m.dtype}")
        logits, m = logits.contiguous(), m.contiguous()
        b, t, c = m.shape
        out = torch.empty(5, b, c, dtype=torch.float32, device=m.device)
        self._launch("sg_asp_stats_fwd", m.device, logits, m, b, t, c, eps,
                     *out)
        return tuple(out)

    def backward(self, logits, m, eps, mu, sigma, lmax, lsum, var, gmu,
                 gsigma):
        if not self.route(m):
            return stats_bwd_plain(logits, m, eps, mu, sigma, lmax, lsum,
                                   var, gmu, gsigma)
        logits, m = logits.contiguous(), m.contiguous()
        b, t, c = m.shape
        dl = torch.empty_like(logits)
        dm = torch.empty_like(m)
        self._launch("sg_asp_stats_bwd", m.device, logits, m, b, t, c, eps,
                     mu, sigma, lmax, lsum, var, gmu.contiguous(),
                     gsigma.contiguous(), dl, dm)
        return dl, dm


asp_stats = _AspStats()


class AttentiveStats(torch.autograd.Function):
    """(logits, m, eps) -> (mu, sigma), each (B, C) float32, through
    ``asp_stats``: the kernel on CUDA tensors, the plain version on CPU
    ones; the backward's cotangent of m in m's dtype."""

    @staticmethod
    def forward(ctx, logits, m, eps):
        mu, sigma, lmax, lsum, var = asp_stats.forward(logits, m, eps)
        ctx.save_for_backward(logits, m, mu, sigma, lmax, lsum, var)
        ctx.eps = eps
        return mu, sigma

    @staticmethod
    def backward(ctx, gmu, gsigma):
        logits, m, mu, sigma, lmax, lsum, var = ctx.saved_tensors
        dl, dm = asp_stats.backward(logits, m, ctx.eps, mu, sigma, lmax,
                                    lsum, var, gmu, gsigma)
        return dl, dm, None
