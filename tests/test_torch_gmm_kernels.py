"""The port's fused GMM kernels (ops/gmm_loglike.py, ops/gmm_stats.py) and
the packed augmentation (models/gmm.py ``_aug_ops``) against the JAX
package's Pallas kernels in interpret mode and its custom VJPs.

On the CPU each wrapper runs its plain version; the CUDA kernels are held
against those plain versions on the card (marked ``cuda``, skipped here,
and by chip_smoke.py).  Sizes follow tests/test_pallas.py: C=128, D=10,
T=37 (T not a multiple of the kernels' 64- or 128-frame tiles).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.models import gmm as G
from speakerguard_tpu.ops.pallas_gmm import fused_loglike_batch
from speakerguard_tpu.ops.pallas_gmm_stats import (_build_aug, _stats_bwd,
                                                   _stats_fwd,
                                                   fused_stats as jax_fused)

from speakerguard_tpu_torch.models import gmm as TG
from speakerguard_tpu_torch.ops import gmm_loglike as L
from speakerguard_tpu_torch.ops import gmm_stats as S

# bf16 keeps 7 fraction bits: one ulp is at most 2^-7 of the value.
BF16_ULP = 2.0 ** -7
# The smallest normal f32 (and bf16): at D = 72 some posteriors fall below
# it, where XLA on the CPU flushes them to zero and bf16's ulp stops
# shrinking with the value.
FTZ_FLOOR = 2.0 ** -126


def _gmm(seed, c=128, d=10):
    """A JAX GMM and its float32 / bf16 tensors for the port."""
    jp = G.random_gmm(np.random.default_rng(seed), c, d)
    proj16 = G.fast_proj(jp)
    t = {"quad_proj": torch.tensor(np.asarray(jp.quad_proj)),
         "gconsts": torch.tensor(np.asarray(jp.gconsts)),
         "proj16": torch.tensor(np.asarray(proj16.astype(jnp.float32))
                                ).to(torch.bfloat16)}
    return jp, proj16, t


def _feats(seed, b=2, t=37, d=10):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _assert_bf16_close(got16, want16, max_share, floor=0.0):
    """bf16 tensors equal except on at most ``max_share`` of the entries,
    which may differ by one bf16 ulp: where an f32 value lies within an f32
    ulp of a bf16 rounding boundary, a different f32 sum order flips it.
    Differences up to ``floor`` pass and are not counted (FTZ_FLOOR)."""
    got = got16.to(torch.float32).numpy()
    want = np.asarray(want16, np.float32)
    diff = np.abs(got - want)
    assert np.all(diff <= np.maximum(
        BF16_ULP * np.maximum(np.abs(got), np.abs(want)), floor)), diff.max()
    assert np.mean(diff > floor) <= max_share, np.mean(diff > floor)


# ---------------------------------------------------------------------------
# A: fused_loglike (exact path, f32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,c", [(64, 8, 128), (37, 10, 128),
                                   (100, 12, 200)])
def test_loglike_plain_matches_jax_kernel(t, d, c):
    """Plain A against fused_loglike_batch(interpret=True): both f32, sums
    in another order over F = D + D(D+1)/2 <= 90 products of O(10)
    magnitude, so 1e-5 relative with an absolute floor of 1e-4."""
    jp, _, tp = _gmm(t, c, d)
    x = _feats(t + 1, 2, t, d)
    want = np.asarray(fused_loglike_batch(jnp.asarray(x), jp.quad_proj,
                                          jp.gconsts, interpret=True))
    L.fused_loglike.reset_counts()
    got = L.fused_loglike(torch.tensor(x), tp["quad_proj"], tp["gconsts"])
    assert (L.fused_loglike.plain_calls, L.fused_loglike.launches) == (1, 0)
    assert got.shape == want.shape == (2, t, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_loglike_fused_value_and_grad_match_jax(monkeypatch):
    """The port's _LoglikeFused (kernel forward, analytic backward
    daug = gbar quad_proj^T + chain) against jax.vjp of gmm._loglike_fused
    routed through the interpret-mode kernel (SG_GMM_PALLAS=1): f32 on
    both sides, 1e-5 relative."""
    monkeypatch.setenv("SG_GMM_PALLAS", "1")
    jp, _, tp = _gmm(3, 130, 10)
    x = _feats(4, 2, 37, 10)
    gbar = np.random.default_rng(5).standard_normal((2, 37, 130)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda f: G._loglike_fused(
        jp.quad_proj, jp.gconsts, jp.means_invcovars, jp.invcovars, f),
        jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(gbar))
    xt = torch.tensor(x, requires_grad=True)
    got = TG.component_loglike(TG.FullGMMParams(
        gconsts=tp["gconsts"], weights=None, means_invcovars=None,
        invcovars=None, means=None, quad_proj=tp["quad_proj"]), xt,
        kernel=True)
    got.backward(torch.tensor(gbar))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_want),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fast", [False, True])
def test_aug_ops_value_and_grad_match_jax(fast):
    """_aug_ops: the one-hot-matmul augmentation (exact: one nonzero term
    per output) and its chain VJP against gmm._aug_ops.  On the CPU the
    fast chain runs in float32 on both sides (fast_dot_dtype), so the bar
    is f32 round-off of a two-term-per-entry sum."""
    d = 9
    x = _feats(6, 2, 20, d)
    cot = np.random.default_rng(7).standard_normal((2, 20, L.aug_dim(d))
                                                   ).astype(np.float32)
    augment, chain = G._aug_ops(d)
    want, vjp = jax.vjp(augment, jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(cot))
    if fast:
        g_want = chain(jnp.asarray(x), jnp.asarray(cot), fast=True)
    xt = torch.tensor(x, requires_grad=True)
    got = TG.augment(xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    if fast:
        g_got = TG.aug_chain(xt.detach(), torch.tensor(cot), fast=True)
    else:
        got.backward(torch.tensor(cot))
        g_got = xt.grad
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# stats_fwd and stats_bwd: fused stats (fast path, bf16 operands / f32
# accumulation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,d,c", [(2, 37, 10, 128), (3, 20, 6, 200)])
def test_stats_fwd_plain_matches_jax_kernel(b, t, d, c):
    """stats_fwd_plain's (zeroth, first, posts16) against
    _stats_fwd(interpret=True).  Same bf16 rounding points on both sides,
    f32 sums in another order (and exp from another library): zeroth and
    first to 1e-5
    relative of their scale; posts16 bit-equal except a one-ulp flip on at
    most 1% of the entries."""
    jp, proj16, tp = _gmm(b * t, c, d)
    x = _feats(b + t, b, t, d)
    jz, jf, jpost = _stats_fwd(jnp.asarray(x), proj16, jp.gconsts,
                               interpret=True)
    S.stats_fwd.reset_counts()
    z, f, post16 = S.stats_fwd(torch.tensor(x), tp["proj16"], tp["gconsts"])
    assert (S.stats_fwd.plain_calls, S.stats_fwd.launches) == (1, 0)
    assert z.shape == (b, c) and f.shape == (b, c, d)
    assert post16.shape == (b, t, c) and post16.dtype == torch.bfloat16
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jz).max()))
    # the JAX kernel pads T to its 128-frame tile with zero posteriors
    assert not np.asarray(jpost[:, t:].astype(jnp.float32)).any()
    jp16 = np.asarray(jpost[:, :t].astype(jnp.float32))
    _assert_bf16_close(post16, jp16, 0.01)
    # first = posts16^T x16: a flipped posts16 entry moves it by exactly
    # |dp16| |x16|, on top of f32 round-off
    flips = np.abs(post16.float().numpy() - jp16)
    bound = (np.einsum("btc,btd->bcd", flips, np.abs(S._bf(
        torch.tensor(x)).numpy())) + 1e-5 * float(np.abs(jf).max()))
    assert np.all(np.abs(f.numpy() - np.asarray(jf)) <= bound)


# the forward's three launches (csrc/gmm_stats_fwd.cu), each by its plain
# version: D = 6, 10 and the model's 72; C = 200 and 64 leave the last
# 256-column softmax tile ragged
LAUNCH_SHAPES = [(2, 37, 10, 128), (3, 20, 6, 200), (2, 9, 72, 64)]


@pytest.mark.parametrize("b,t,d,c", LAUNCH_SHAPES)
def test_stats_fwd_launches_compose_to_plain_and_jax(b, t, d, c):
    """aug16 -> loglike GEMM with softmax partials -> normalise-and-stats,
    run through the launch helpers on CPU tensors (their plain versions),
    against stats_fwd_plain (f32 sums in another order: 1e-5 of the scale;
    posts16 equal but for one-ulp flips on at most 1% of the entries) and
    against _stats_fwd(interpret=True) at
    test_stats_fwd_plain_matches_jax_kernel's tolerances."""
    jp, proj16, tp = _gmm(b * t + 2, c, d)
    x = _feats(b + t + 2, b, t, d)
    xt = torch.tensor(x)
    loglike, part = S.loglike_partials(S.augment16_padded(xt),
                                       S.proj_kmajor(tp["proj16"]),
                                       tp["gconsts"])
    z, f, post16 = S.normalise_stats(loglike, part, xt)
    assert z.shape == (b, c) and f.shape == (b, c, d)
    assert post16.shape == (b, t, c) and post16.dtype == torch.bfloat16
    zw, fw, pw = S.stats_fwd_plain(xt, tp["proj16"], tp["gconsts"])
    np.testing.assert_allclose(z.numpy(), zw.numpy(), rtol=1e-5,
                               atol=1e-5 * float(zw.abs().max()))
    _assert_bf16_close(post16, pw.float().numpy(), 0.01, FTZ_FLOOR)

    jz, jf, jpost = _stats_fwd(jnp.asarray(x), proj16, jp.gconsts,
                               interpret=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jz).max()))
    jp16 = np.asarray(jpost[:, :t].astype(jnp.float32))
    _assert_bf16_close(post16, jp16, 0.01, FTZ_FLOOR)
    for want, want16 in ((fw.numpy(), pw.float().numpy()),
                         (np.asarray(jf), jp16)):
        flips = np.abs(post16.float().numpy() - want16)
        bound = (np.einsum("btc,btd->bcd", flips, np.abs(S._bf(xt).numpy()))
                 + 1e-5 * float(np.abs(want).max()))
        assert np.all(np.abs(f.numpy() - want) <= bound)


@pytest.mark.parametrize("d", [6, 10, 72])
def test_aug16_and_projk_are_padded_with_zeros(d):
    """aug16's columns equal the JAX kernel's bf16 augmentation (_build_aug,
    the same roundings) bit for bit, and its pad columns up to the 64-column
    K tile are exactly zero; projK is proj16^T with exactly zero pad
    columns."""
    f = L.aug_dim(d)
    x = _feats(d, 2, 7, d)
    aug16 = S.augment16_padded(torch.tensor(x))
    f_pad = S.padded_k(f)
    assert aug16.shape == (14, f_pad) and f_pad % 64 == 0 and f_pad - f < 64
    want = np.asarray(_build_aug(jnp.asarray(x.reshape(14, d)), d, f, f,
                                 jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(aug16[:, :f].float().numpy(), want)
    assert not aug16[:, f:].float().any()
    _, _, tp = _gmm(d, 96, d)
    projk = S.proj_kmajor(tp["proj16"])
    assert projk.shape == (96, f_pad) and projk.dtype == torch.bfloat16
    assert torch.equal(projk[:, :f], tp["proj16"].T)
    assert not projk[:, f:].float().any()


@pytest.mark.parametrize("c", [64, 200, 2048])
def test_partials_combine_to_row_max_and_logsumexp(c):
    """The per-256-column partials of loglike_partials_plain, combined in
    tile order, give each row's max exactly and its log-sum-exp to 1e-6
    relative: the ragged last tile (C = 64, 200) leaves its pad columns out
    (each would add exp(gconsts - max) to the sum)."""
    d = 10
    _, _, tp = _gmm(c, c, d)
    xt = torch.tensor(_feats(c + 1, 2, 11, d))
    loglike, part = S.loglike_partials(S.augment16_padded(xt),
                                       S.proj_kmajor(tp["proj16"]),
                                       tp["gconsts"])
    assert part.shape == (22, -(-c // 256), 2)
    m, s = S.combine_partials(part)
    assert torch.equal(m[:, 0], loglike.amax(dim=-1))
    lse = torch.logsumexp(loglike.double(), dim=-1)
    np.testing.assert_allclose((m[:, 0] + torch.log(s[:, 0])).double(), lse,
                               rtol=1e-6)


@pytest.mark.parametrize("b,t,d,c", [(2, 37, 10, 128), (3, 20, 6, 200)])
def test_stats_bwd_plain_matches_jax_kernel(b, t, d, c):
    """stats_bwd_plain's dx against _stats_bwd(interpret=True), both fed
    the same posts16 (the JAX forward's) and cotangents: identical bf16
    rounding points, f32 sums in another order, 1e-5 of the gradient's
    scale."""
    jp, proj16, tp = _gmm(b * t + 1, c, d)
    x = _feats(b + t + 1, b, t, d)
    rng = np.random.default_rng(8)
    dz = rng.standard_normal((b, c)).astype(np.float32)
    df = rng.standard_normal((b, c, d)).astype(np.float32)
    _, _, jpost = _stats_fwd(jnp.asarray(x), proj16, jp.gconsts,
                             interpret=True)
    want = np.asarray(_stats_bwd(jnp.asarray(x), proj16, jpost,
                                 jnp.asarray(dz), jnp.asarray(df),
                                 interpret=True))
    post16 = torch.tensor(np.asarray(jpost[:, :t].astype(jnp.float32))
                          ).to(torch.bfloat16)
    S.stats_bwd.reset_counts()
    got = S.stats_bwd(torch.tensor(x), tp["proj16"], post16,
                      torch.tensor(dz), torch.tensor(df)).numpy()
    assert (S.stats_bwd.plain_calls, S.stats_bwd.launches) == (1, 0)
    assert got.shape == want.shape == (b, t, d)
    _assert_grad_close(got, want)


# the backward's three launches (csrc/gmm_stats_bwd.cu), each by its plain
# version: D = 6 and 10, C = 64, 128 and 200, T no multiple of the 64-frame
# tile
BWD_LAUNCH_SHAPES = [(2, 37, 10, 128), (3, 20, 6, 200), (2, 45, 6, 64),
                     (2, 70, 10, 200), (3, 29, 10, 64), (2, 65, 6, 128)]


def _bwd_inputs(b, t, d, c, seed):
    """The JAX GMM, x, cotangents and the JAX forward's posts16 (also as a
    torch bf16 tensor) at one shape."""
    jp, proj16, tp = _gmm(seed, c, d)
    x = _feats(seed + 1, b, t, d)
    rng = np.random.default_rng(seed + 2)
    dz = rng.standard_normal((b, c)).astype(np.float32)
    df = rng.standard_normal((b, c, d)).astype(np.float32)
    _, _, jpost = _stats_fwd(jnp.asarray(x), proj16, jp.gconsts,
                             interpret=True)
    post16 = torch.tensor(np.asarray(jpost[:, :t].astype(jnp.float32))
                          ).to(torch.bfloat16)
    return proj16, tp, x, dz, df, jpost, post16


@pytest.mark.parametrize("b,t,d,c", BWD_LAUNCH_SHAPES)
def test_stats_bwd_launches_compose_to_plain_and_jax(b, t, d, c):
    """dl and the direct term -> the daug GEMM -> the chain rule and sum,
    run through the launch helpers on CPU tensors (their plain versions),
    against stats_bwd_plain (f32 sums in another order: 1e-6 of the
    gradient's scale) and against _stats_bwd(interpret=True) under
    _assert_grad_close, both fed the JAX forward's posts16."""
    proj16, tp, x, dz, df, jpost, post16 = _bwd_inputs(b, t, d, c,
                                                       b * t + c + d)
    xt, dzt, dft = torch.tensor(x), torch.tensor(dz), torch.tensor(df)
    dl16, direct = S.dl_direct(xt, post16, dzt, dft)
    assert dl16.shape == (b * t, c) and dl16.dtype == torch.bfloat16
    assert direct.shape == (b * t, d) and direct.dtype == torch.float32
    daug = S.daug_gemm(dl16, tp["proj16"])
    assert daug.shape == (b * t, L.aug_dim(d))
    dx = S.chain_sum(daug, xt, direct)
    assert dx.shape == (b, t, d) and dx.dtype == torch.float32
    want = S.stats_bwd_plain(xt, tp["proj16"], post16, dzt, dft)
    np.testing.assert_allclose(dx.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    jwant = np.asarray(_stats_bwd(jnp.asarray(x), proj16, jpost,
                                  jnp.asarray(dz), jnp.asarray(df),
                                  interpret=True))
    _assert_grad_close(dx.numpy(), jwant)


@pytest.mark.parametrize("b,t,d,c", BWD_LAUNCH_SHAPES[:3])
def test_dl_plain_rounds_once_and_direct_is_posts16_df16(b, t, d, c):
    """dl_direct_plain's bf16(dl) is dl_plain rounded once (the softmax VJP
    in f32: rows of posts (dp - sum_c posts dp) with dp = dz + x16 df16^T,
    which sum to ~0 over c since the posteriors sum to 1), and its direct
    term is posts16 . bf16(df) exactly as the plain f32 product."""
    _, _, x, dz, df, _, post16 = _bwd_inputs(b, t, d, c, b + t + c)
    xt, dzt, dft = torch.tensor(x), torch.tensor(dz), torch.tensor(df)
    dl = S.dl_plain(xt, post16, dzt, dft)
    dl16, direct = S.dl_direct_plain(xt, post16, dzt, dft)
    assert torch.equal(dl16, dl.to(torch.bfloat16))
    scale = float(dl.abs().max())
    assert float(dl.sum(dim=-1).abs().max()) <= 1e-2 * scale
    df16 = S._bf(dft)
    want = torch.einsum("btc,bcd->btd", post16.float(), df16)
    np.testing.assert_allclose(direct.numpy(), want.reshape(-1, d).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [6, 10, 72])
def test_chain_sum_plain_is_chain_plus_linear_and_direct(d):
    """chain_sum_plain (the symmetric D x D form the card's launch uses)
    equals chain_plain (the packed VJP, index_add) plus daug[:, :D] plus
    the direct term: f32 sums of D + 3 terms in another order, 1e-6 of the
    largest sum of absolute terms."""
    rng = np.random.default_rng(d)
    b, t = 2, 9
    x = torch.tensor(rng.standard_normal((b, t, d)).astype(np.float32))
    daug = torch.tensor(rng.standard_normal((b * t, L.aug_dim(d))
                                            ).astype(np.float32))
    direct = torch.tensor(rng.standard_normal((b * t, d)).astype(np.float32))
    got = S.chain_sum_plain(daug, x, direct)
    want = (S.chain_plain(daug[:, d:].reshape(b, t, -1), x)
            + daug[:, :d].reshape(b, t, d) + direct.reshape(b, t, d))
    terms = float(S.chain_sum_plain(daug.abs(), x.abs(), direct.abs()).max())
    assert float((got - want).abs().max()) <= 1e-6 * terms


def _assert_grad_close(got, want, share=0.05, flip_bar=2e-3):
    """dx from the same bf16 rounding points: f32 round-off (1e-5 of the
    gradient's scale) on at least 1 - ``share`` of the entries; the rest
    within ``flip_bar`` of the scale, where bf16(dl) sits at a rounding
    boundary and one ulp (2^-7 relative) of one dl entry moves daug."""
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert np.mean(err > 1e-5 * scale) <= share, np.mean(err > 1e-5 * scale)
    assert err.max() <= flip_bar * scale, err.max() / scale


def test_fused_stats_value_and_grad_match_jax():
    """The autograd Function fused_stats against jax.vjp of the JAX
    fused_stats (interpret mode), cotangents from a numpy seed.  Each side
    differentiates through its own posts16, so a one-ulp posts16 flip moves
    one entry of one term: 1e-4 of the gradient's scale."""
    jp, proj16, tp = _gmm(11)
    x = _feats(12)
    rng = np.random.default_rng(13)
    dz = rng.standard_normal((2, 128)).astype(np.float32)
    df = rng.standard_normal((2, 128, 10)).astype(np.float32)
    (jz, jf), vjp = jax.vjp(lambda f: jax_fused(proj16, jp.gconsts, f, True),
                            jnp.asarray(x))
    (g_want,) = vjp((jnp.asarray(dz), jnp.asarray(df)))
    xt = torch.tensor(x, requires_grad=True)
    z, f = S.fused_stats(tp["proj16"], tp["gconsts"], xt)
    torch.autograd.backward((z, f), (torch.tensor(dz), torch.tensor(df)))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jz).max()))
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jf).max()))
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(xt.grad.numpy(), g_want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(g_want).max()))


def _stats_loss(z, f):
    return z[:, :5].sum() + (f[:, :3, :] ** 2).sum()


def test_fused_stats_track_exact_stats_and_grads():
    """Mirror of tests/test_pallas.py:83,101: the fused stats (bf16 operands
    by design) track the exact f32 stats within bf16 drift, and their input
    gradient the exact autograd gradient in direction and sign."""
    _, _, tp = _gmm(21)
    p = TG.FullGMMParams(gconsts=tp["gconsts"], weights=None,
                         means_invcovars=None, invcovars=None, means=None,
                         quad_proj=tp["quad_proj"],
                         quad_proj_bf16=tp["proj16"])
    x = _feats(22)
    grads, stats = [], []
    for fused in (False, True):
        xt = torch.tensor(x, requires_grad=True)
        z, f = (S.fused_stats(tp["proj16"], tp["gconsts"], xt) if fused
                else TG.zeroth_first_stats(p, xt))
        _stats_loss(z, f).backward()
        grads.append(xt.grad.numpy())
        stats.append((z.detach().numpy(), f.detach().numpy()))
    (z_ex, f_ex), (z_k, f_k) = stats
    np.testing.assert_allclose(z_k, z_ex, rtol=0.05, atol=0.03)
    np.testing.assert_allclose(f_k, f_ex, rtol=0.05, atol=0.06)
    g_ex, g_k = grads
    cos = (g_ex * g_k).sum() / (np.linalg.norm(g_ex) * np.linalg.norm(g_k))
    assert cos > 0.999
    nz = np.abs(g_ex) > np.abs(g_ex).max() * 1e-3
    assert np.mean(np.sign(g_ex[nz]) == np.sign(g_k[nz])) > 0.99


def test_stats_dispatch_kernel_or_unfused():
    """Mirror of tests/test_pallas.py:129: FastPath(stats_kernel=True)
    routes zeroth_first_stats through the fused stats (counted), and the
    unfused fast block agrees with it within bf16 drift."""
    from speakerguard_tpu_torch.models.base import FastPath
    _, _, tp = _gmm(23)
    p = TG.FullGMMParams(gconsts=tp["gconsts"], weights=None,
                         means_invcovars=None, invcovars=None, means=None,
                         quad_proj=tp["quad_proj"],
                         quad_proj_bf16=tp["proj16"])
    x = torch.tensor(_feats(24))
    S.stats_fwd.reset_counts()
    with torch.no_grad():
        z_u, f_u = TG.zeroth_first_stats(p, x, fast=FastPath(gmm_topk=0))
        assert S.stats_fwd.plain_calls == 0
        z_k, f_k = TG.zeroth_first_stats(
            p, x, fast=FastPath(gmm_topk=0, stats_kernel=True))
    assert S.stats_fwd.plain_calls == 1
    np.testing.assert_allclose(z_k.numpy(), z_u.numpy(), rtol=0.05,
                               atol=0.03)
    np.testing.assert_allclose(f_k.numpy(), f_u.numpy(), rtol=0.05,
                               atol=0.06)


def test_iv_plda_scores_invariant_to_loglike_kernel():
    """Mirror of tests/test_pallas.py:58: the iv-PLDA scores do not depend
    on the exact path's loglike backend (the kernel's plain version here),
    and the kernel runs once per scoring."""
    import dataclasses
    from speakerguard_tpu.models.iv_plda import random_iv_plda_params
    from speakerguard_tpu_torch.convert import from_jax_params
    from speakerguard_tpu_torch.models.iv_plda import IvPlda
    from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC
    params = from_jax_params(jax.tree.map(np.asarray, random_iv_plda_params(
        np.random.default_rng(25), num_gaussians=128, dim=72,
        ivector_dim=64, reduced_dim=32)), device="cpu")
    cfg = dataclasses.replace(IV_PLDA_MFCC, dither=0.0)
    enroll = np.random.default_rng(26).standard_normal((3, 32))
    wavs = torch.tensor(np.random.default_rng(27).uniform(
        -0.3, 0.3, (2, 8000)).astype(np.float32))
    scores = []
    for kernel in (False, True):
        model = IvPlda(params, mfcc_config=cfg, loglike_kernel=kernel)
        model.set_enrollment(["a", "b", "c"], enroll)
        L.fused_loglike.reset_counts()
        with torch.no_grad():
            scores.append(model.score(wavs).numpy())
        assert L.fused_loglike.plain_calls == int(kernel)
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-4, atol=2e-3)


def test_wrappers_check_their_operands():
    _, _, tp = _gmm(1)
    x = torch.zeros(2, 5, 10)
    with pytest.raises(TypeError):
        S.stats_fwd(x, tp["proj16"].float(), tp["gconsts"])
    with pytest.raises(ValueError):
        S.stats_fwd(torch.zeros(2, 5, 9), tp["proj16"], tp["gconsts"])
    with pytest.raises(TypeError):
        L.fused_loglike(x, tp["proj16"], tp["gconsts"])
    with pytest.raises(ValueError):
        S.stats_bwd(x, tp["proj16"], torch.zeros(2, 5, 128,
                                                 dtype=torch.bfloat16),
                    torch.zeros(2, 128), torch.zeros(2, 128, 9))


def _bad_bwd_operands():
    """(name, args) pairs the backward's wrapper or one of its launch
    helpers must refuse: a wrong shape or dtype each."""
    _, _, tp = _gmm(1)
    x = torch.zeros(2, 5, 10)
    p16 = torch.zeros(2, 5, 128, dtype=torch.bfloat16)
    dz, df = torch.zeros(2, 128), torch.zeros(2, 128, 10)
    dl16 = torch.zeros(10, 128, dtype=torch.bfloat16)
    daug, direct = torch.zeros(10, 65), torch.zeros(10, 10)
    return {
        "stats_bwd posts16 f32": (S.stats_bwd, (x, tp["proj16"], p16.float(),
                                                dz, df)),
        "stats_bwd proj16 f32": (S.stats_bwd, (x, tp["proj16"].float(), p16,
                                               dz, df)),
        "stats_bwd dzeroth (2, 127)": (S.stats_bwd, (x, tp["proj16"], p16,
                                                     dz[:, 1:], df)),
        "dl_direct posts16 f32": (S.dl_direct, (x, p16.float(), dz, df)),
        "dl_direct dfirst (2, 128, 9)": (S.dl_direct, (x, p16, dz,
                                                       df[..., 1:])),
        "daug_gemm proj16 f32": (S.daug_gemm, (dl16, tp["proj16"].float())),
        "daug_gemm C mismatch": (S.daug_gemm, (dl16[:, 1:], tp["proj16"])),
        "chain_sum daug (10, 64)": (S.chain_sum, (daug[:, 1:], x, direct)),
        "chain_sum direct bf16": (S.chain_sum, (daug, x,
                                                direct.bfloat16())),
    }


@pytest.mark.parametrize("case", [
    "stats_bwd posts16 f32", "stats_bwd proj16 f32",
    "stats_bwd dzeroth (2, 127)", "dl_direct posts16 f32",
    "dl_direct dfirst (2, 128, 9)", "daug_gemm proj16 f32",
    "daug_gemm C mismatch", "chain_sum daug (10, 64)",
    "chain_sum direct bf16"])
def test_stats_bwd_and_its_launches_check_their_operands(case):
    fn, args = _bad_bwd_operands()[case]
    with pytest.raises(ValueError):
        fn(*args)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

CARD_SHAPES = [(64, 300, 72, 2048), (3, 37, 10, 200), (2, 130, 6, 64)]


def _card_inputs(b, t, d, c):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    jp = TG.random_gmm(np.random.default_rng(c + d), c, d, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(t)
    x = torch.randn((b, t, d), generator=g, device="cuda")
    return jp, x, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,c", CARD_SHAPES)
def test_cuda_loglike_kernel_matches_plain(b, t, d, c):
    """f32 sums of F products in another order: 2e-6 of the largest
    |loglike| (its terms are no larger than it here)."""
    p, x, _ = _card_inputs(b, t, d, c)
    L.fused_loglike.reset_counts()
    got = L.fused_loglike(x, p.quad_proj, p.gconsts)
    torch.cuda.synchronize()
    assert L.fused_loglike.launches == 1
    want = L.fused_loglike_plain(x, p.quad_proj, p.gconsts)
    assert float((got - want).abs().max()) <= 2e-6 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,c", CARD_SHAPES)
def test_cuda_stats_kernels_match_plain(b, t, d, c):
    """stats_fwd against its plain version, and stats_bwd against its
    plain version on the posts16 that the stats_fwd kernel produced.  The
    kernel's loglike sums 2700 tensor-core products in another order than
    the plain f32 GEMM (1e-4
    absolute at loglikes of a few hundred, measured at the main shape), so
    a posterior moves by ~1e-4 of itself: posts16 is held to the plain f32
    posteriors at half a bf16 ulp (its rounding) + 1e-3 relative; zeroth
    to 1e-4 of its scale (measured 1.8e-5); first to 1e-5 of its scale plus
    exactly what the posts16 differences move; dx by _assert_grad_close."""
    p, x, g = _card_inputs(b, t, d, c)
    proj16 = p.quad_proj.to(torch.bfloat16)
    S.stats_fwd.reset_counts()
    S.stats_bwd.reset_counts()
    z, f, post16 = S.stats_fwd(x, proj16, p.gconsts)
    torch.cuda.synchronize()
    zw, fw, pw = S.stats_fwd_plain(x, proj16, p.gconsts)
    pf = S.posteriors_plain(x, proj16, p.gconsts)
    assert float((z - zw).abs().max()) <= 1e-4 * float(zw.abs().max())
    assert bool(((post16.float() - pf).abs()
                 <= (2.0 ** -8 + 1e-3) * pf.abs() + 1e-37).all())
    flips = (post16.float() - pw.float()).abs()
    bound = (flips.mT @ S._bf(x).abs()) + 1e-5 * float(fw.abs().max())
    assert bool(((f - fw).abs() <= bound).all())
    dz = torch.randn((b, c), generator=g, device="cuda")
    df = torch.randn((b, c, d), generator=g, device="cuda")
    dx = S.stats_bwd(x, proj16, post16, dz, df)
    torch.cuda.synchronize()
    assert (S.stats_fwd.launches, S.stats_bwd.launches) == (1, 1)
    want = S.stats_bwd_plain(x, proj16, post16, dz, df)
    _assert_grad_close(dx.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,c", CARD_SHAPES)
def test_cuda_stats_fwd_launches_match_plain(b, t, d, c):
    """Each of stats_fwd's launches against its plain version on the same
    inputs (chip_smoke.py phase_stats_fwd_launches gives the reasons): aug16
    torch.equal; the GEMM's loglike within 2e-6 of the largest sum of
    absolute terms; the tile maxima equal and the sums within 1e-5
    relative of the plain partials of the kernel's own loglike."""
    p, x, _ = _card_inputs(b, t, d, c)
    aug16 = S.augment16_padded(x)
    assert torch.equal(aug16, S.augment16_padded_plain(x))
    projk = S.proj_kmajor(p.quad_proj.to(torch.bfloat16))
    loglike, part = S.loglike_partials(aug16, projk, p.gconsts)
    torch.cuda.synchronize()
    want, _ = S.loglike_partials_plain(aug16, projk, p.gconsts)
    terms = (aug16.float().abs() @ projk.float().abs().T
             + p.gconsts.abs()).max()
    assert float((loglike - want).abs().max()) <= 2e-6 * float(terms)
    part_k = S.tile_partials(loglike)
    assert torch.equal(part[..., 0], part_k[..., 0])
    assert float(((part[..., 1] - part_k[..., 1]).abs()
                  / part_k[..., 1]).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,c", CARD_SHAPES + [(2, 45, 6, 100)])
def test_cuda_stats_bwd_launches_match_plain(b, t, d, c):
    """Each of stats_bwd's launches against its plain version on the same
    inputs (chip_smoke.py phase_stats_bwd_launches gives the reasons; C =
    100 takes the scalar posts16 loads and the zero-padded TMA operands):
    bf16(dl) within one bf16 ulp of the plain f32 dl plus posts 1e-5 of the
    row's largest sum of absolute terms of dp; the direct term and daug
    within 2e-6, the chain within 1e-6, of their largest sums of absolute
    terms."""
    p, x, g = _card_inputs(b, t, d, c)
    proj16 = p.quad_proj.to(torch.bfloat16)
    dz = torch.randn((b, c), generator=g, device="cuda")
    df = torch.randn((b, c, d), generator=g, device="cuda")
    post16 = S.stats_fwd(x, proj16, p.gconsts)[2]
    dl16, direct = S.dl_direct(x, post16, dz, df)
    torch.cuda.synchronize()
    dl = S.dl_plain(x, post16, dz, df)
    posts = post16.reshape(b * t, c).float()
    dp_terms = (dz.abs()[:, None, :] + S._bf(x).abs() @ S._bf(df).abs().mT
                ).amax(dim=-1).reshape(-1, 1)
    ulp = torch.clamp_min(BF16_ULP * torch.maximum(dl.abs(),
                                                   dl16.float().abs()),
                          2.0 ** -133)
    assert bool(((dl16.float() - dl).abs()
                 <= ulp + 1e-5 * posts * dp_terms).all())
    want = S.dl_direct_plain(x, post16, dz, df)[1]
    terms = float((post16.float() @ S._bf(df).abs()).max())
    assert float((direct - want).abs().max()) <= 2e-6 * terms

    daug = S.daug_gemm(dl16, proj16)
    torch.cuda.synchronize()
    terms = float((dl16.float().abs() @ proj16.float().abs().T).max())
    assert float((daug - S.daug_plain(dl16, proj16)).abs().max()) <= (
        2e-6 * terms)

    dx = S.chain_sum(daug, x, direct)
    torch.cuda.synchronize()
    terms = float(S.chain_sum_plain(daug.abs(), x.abs(), direct.abs()).max())
    assert float((dx - S.chain_sum_plain(daug, x, direct)).abs().max()) <= (
        1e-6 * terms)
