"""ops/asp_pool.py: ECAPA-TDNN's attentive statistics, their plain versions
and the kernel's wrapper on the CPU; the kernel itself on the card.

The plain forward is held to torch's softmax and the centred weighted
statistics in float64, the plain backward to autograd of the plain forward
in float64; both within 1e-6 of the largest entry in float32 (sums in
another order).  The kernel's route runs on the CPU with each launch
emulated from its operands (the plain version written into the buffers the
wrapper hands the C entry point), so the wrapper's plumbing is checked
here.  On the card (``-m cuda``) the kernel is held to the plain version:
the statistics and the logits' cotangent within 1e-5 of their largest
entry (float32 sums over 300 frames in another order, and expf against
torch's exp), the bf16 cotangent of m within one bf16 ulp of its largest
entry (its own rounding, on a float32 value within that 1e-5).

This file runs on one CPU thread and imports no JAX.
"""

from types import SimpleNamespace

import pytest
import torch

from speakerguard_tpu_torch.ops import asp_pool as AP

from tdnn_bars import bf16_ulp
from test_torch_tdnn_conv import one_cpu_thread  # noqa: F401

EPS = 1e-12


def _case(b, t, c, device="cpu", seed=0, m_dtype=torch.float32):
    """Logits and activations (B, T, C) with one channel constant over
    time (its variance 0: the clamp's side) and cotangents (B, C)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = 2.0 * torch.randn(b, t, c, generator=gen, device=device)
    m = torch.randn(b, t, c, generator=gen, device=device)
    m[:, :, 0] = 0.25
    gmu = torch.randn(b, c, generator=gen, device=device)
    gsig = torch.randn(b, c, generator=gen, device=device)
    return logits, m.to(m_dtype), gmu, gsig


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def test_plain_forward_is_softmax_weighted_statistics():
    logits, m, _, _ = _case(3, 41, 37)
    mu, sigma, lmax, lsum, var = AP.stats_fwd_plain(logits, m, EPS)
    alpha = torch.softmax(logits.double(), dim=1)
    x = m.double()
    want_mu = (alpha * x).sum(1)
    want_var = (alpha * (x - want_mu[:, None]) ** 2).sum(1)
    assert _rel(mu, want_mu) <= 1e-6
    assert _rel(var, want_var) <= 1e-6
    assert _rel(sigma, torch.sqrt(want_var.clamp(min=EPS))) <= 1e-6
    assert float(var[:, 0].abs().max()) <= 1e-12     # the constant channel
    assert torch.equal(lmax, logits.amax(1))
    assert _rel(lsum, torch.exp(logits.double() - lmax[:, None].double())
                .sum(1)) <= 1e-6


def test_plain_backward_is_autograd_of_the_forward():
    logits, m, gmu, gsig = _case(2, 33, 19, seed=1)
    lg = logits.double().requires_grad_(True)
    md = m.double().requires_grad_(True)
    mu, sigma, *_ = AP.stats_fwd_plain(lg, md, EPS)
    want_dl, want_dm = torch.autograd.grad(
        (mu * gmu.double()).sum() + (sigma * gsig.double()).sum(), (lg, md))
    with torch.no_grad():
        saved = AP.stats_fwd_plain(logits, m, EPS)
    dl, dm = AP.stats_bwd_plain(logits, m, EPS, *saved, gmu, gsig)
    assert _rel(dl, want_dl) <= 1e-6
    assert _rel(dm, want_dm) <= 1e-6
    # the constant channel's variance is under eps: no sigma term there
    assert float((dm[:, :, 0].double() - want_dm[:, :, 0]).abs().max()) \
        <= 1e-6 * float(want_dm.abs().max())


@pytest.fixture
def emulated(monkeypatch):
    """The wrapper's kernel route on CPU tensors: each launch writes the
    plain version's results into the buffers it is handed, in the entry
    point's argument order."""
    w = AP.asp_stats

    def launch(entry, device, logits, m, b, t, c, eps, *rest):
        assert logits.is_contiguous() and m.is_contiguous()
        assert (b, t, c) == tuple(m.shape)
        if entry == "sg_asp_stats_fwd":
            for buf, v in zip(rest, AP.stats_fwd_plain(logits, m, eps)):
                buf.copy_(v)
        else:
            saved, (gmu, gsig), (dl, dm) = rest[:5], rest[5:7], rest[7:]
            got = AP.stats_bwd_plain(logits, m, eps, *saved, gmu, gsig)
            dl.copy_(got[0])
            dm.copy_(got[1])

    monkeypatch.setattr(w, "on_card", lambda t, what: True)
    monkeypatch.setattr(w, "lib", SimpleNamespace(launch=launch))
    w.reset_counts()
    yield w
    w.reset_counts()


def _through_function(logits, m, gmu, gsig):
    lg = logits.clone().requires_grad_(True)
    mm = m.clone().requires_grad_(True)
    mu, sigma = AP.AttentiveStats.apply(lg, mm, EPS)
    dl, dm = torch.autograd.grad((mu * gmu).sum() + (sigma * gsig).sum(),
                                 (lg, mm))
    return mu.detach(), sigma.detach(), dl, dm


def _assert_bf16_close(got, want, rel):
    """Within one bf16 ulp of the largest entry, plus ``rel`` of it."""
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= \
        float(bf16_ulp(top)) + rel * top


def test_kernel_route_plumbing(emulated):
    """Strided inputs made contiguous, the five statistics and the two
    cotangents in the entry points' order, bf16 m's cotangent in bf16;
    two launches; the plain route's numbers (to float32 sums over another
    memory order)."""
    logits, m, gmu, gsig = _case(2, 30, 70, seed=2, m_dtype=torch.bfloat16)
    logits = logits.transpose(1, 2).contiguous().transpose(1, 2)
    got = _through_function(logits, m, gmu, gsig)
    assert emulated.launches == 2 and got[3].dtype == torch.bfloat16
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(emulated, "route", lambda t: False)
        want = _through_function(logits, m, gmu, gsig)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= 1e-6
    _assert_bf16_close(got[3], want[3], 1e-6)


def test_cpu_tensors_take_the_plain_version():
    w = AP.asp_stats
    w.reset_counts()
    _through_function(*_case(2, 20, 8, seed=3))
    assert (w.launches, w.plain_calls) == (0, 2)
    w.reset_counts()


@pytest.mark.parametrize("case", ["shape", "logits_dtype", "m_dtype"])
def test_wrapper_refuses(emulated, case):
    logits, m, _, _ = _case(2, 10, 8, m_dtype=torch.bfloat16)
    bad = {"shape": (logits, m[:, :9]),
           "logits_dtype": (logits.double(), m),
           "m_dtype": (logits, m.float())}[case]
    with pytest.raises((ValueError, TypeError)):
        AP.asp_stats.forward(*bad, EPS)
    assert emulated.launches == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_SHAPES = {"b16_t300_c1536": (16, 300, 1536), "b3_t77_c100": (3, 77, 100),
               "b5_t5_c33": (5, 5, 33)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(shape):
    """ECAPA's shape (T 300, MFA 1536), C not a multiple of the block's
    32 channels with T not one of its 8 warps, and T under 8 (warps with
    no frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    logits, m, gmu, gsig = _case(*CARD_SHAPES[shape], device="cuda",
                                 m_dtype=torch.bfloat16)
    w = AP.asp_stats
    w.reset_counts()
    got = _through_function(logits, m, gmu, gsig)
    torch.cuda.synchronize()
    assert (w.launches, w.plain_calls) == (2, 0)
    saved = AP.stats_fwd_plain(logits, m, EPS)
    want = saved[:2] + AP.stats_bwd_plain(logits, m, EPS, *saved, gmu, gsig)
    for g, wnt in zip(got[:3], want[:3]):
        assert _rel(g, wnt) <= 1e-5
    _assert_bf16_close(got[3], want[3], 1e-5)
