"""The port's fast attack-gradient path (models/base.py ``FastPath``) against
the JAX package's fast path on the CPU, on the same weights.

On the JAX side only, monkeypatch sets SG_FAST=1 (the path is off by default
off the TPU), SG_CHOL_PALLAS=1 and SG_CHOL_NB=32: JAX then factors L with
the interpret-mode ``cholesky_rt`` at the port's panel size, with
``bf16_updates`` as on its fast path, instead of LAPACK.  As in JAX, the
fast path on the CPU computes in float32 on the bf16-rounded weight copies
(``fast_dot_dtype``), while the fused stats kernels' plain versions keep
their bf16 rounding points.  Sizes: C=128, D=72 (24 ceps x 3), IV=32, R=16,
8000-sample waves, dither 0.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import PGD as JaxPGD
from speakerguard_tpu.attacks import FGSM as JaxFGSM, CWinf as JaxCWinf
from speakerguard_tpu.models import gmm as JG
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import (
    embedding_from_cmvn as jax_embedding_from_cmvn,
    make_fast_context as jax_make_fast_context, random_iv_plda_params)
from speakerguard_tpu.ops.kaldi_mfcc import IV_PLDA_MFCC as JAX_IV_MFCC

from speakerguard_tpu_torch.attacks import CWinf, FGSM, PGD
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models import gmm as TG
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                   embedding_from_cmvn,
                                                   make_fast_context)
from speakerguard_tpu_torch.ops import chol
from speakerguard_tpu_torch.ops.chol import cholesky_rt
from speakerguard_tpu_torch.ops.gmm_loglike import fused_loglike
from speakerguard_tpu_torch.ops.gmm_stats import stats_bwd, stats_fwd
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC

from test_torch_chol_family import JAX_SOLVER_ENV

KERNELS = FastPath(gmm_topk=0, stats_kernel=True)
CONFIGS = {  # port FastPath, the JAX variables that select the same path
    "topk": (FastPath(gmm_topk=64), {"SG_GMM_TOPK": "64"}),
    "kernels": (KERNELS, {"SG_GMM_TOPK": "0", "SG_GMM_STATS_PALLAS": "1"}),
}


@pytest.fixture(scope="module")
def iv():
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=128, dim=72,
                                   ivector_dim=32, reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    jax_model = JaxIvPlda(params, mfcc_config=dataclasses.replace(
        JAX_IV_MFCC, dither=0.0))
    jax_model.set_enrollment([str(i) for i in range(5)], enroll)
    tparams = from_jax_params(jax.tree.map(np.asarray, params),
                              device="cpu")
    wavs = np.random.default_rng(5).uniform(-0.25, 0.25, (3, 8000)).astype(
        np.float32)
    return jax_model, tparams, enroll, wavs


def _port(tparams, enroll, fast=None, loglike_kernel=False):
    m = IvPlda(tparams, mfcc_config=dataclasses.replace(IV_PLDA_MFCC,
                                                        dither=0.0),
               fast=fast, loglike_kernel=loglike_kernel)
    m.set_enrollment([str(i) for i in range(5)], enroll)
    return m


def _jax_env(monkeypatch, extra=None):
    for k, v in {"SG_FAST": "1", "SG_CHOL_PALLAS": "1", "SG_CHOL_NB": "32",
                 **(extra or {})}.items():
        monkeypatch.setenv(k, v)


def _assert_same_selection(port_sel, jax_sel, fgmm, jfeats):
    """The two top-K selections rank the same scores (JAX's own, recomputed
    here as make_topk_context does on the CPU): components whose scores
    tie to f32 round-off at the K-th place may swap, so the sorted scores
    of the two selections agree rather than the sets."""
    aug = JG._augment(jfeats, fgmm.dim)
    loglike = aug @ JG.fast_proj(fgmm).astype(jnp.float32) + fgmm.gconsts
    score = np.asarray(jnp.max(jnp.mean(jax.nn.softmax(loglike, axis=-1),
                                        axis=-2), axis=0))
    got = np.sort(score[np.asarray(port_sel)])
    want = np.sort(score[np.asarray(jax_sel)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_fast_none_is_off_on_cpu(iv):
    """fast=None is JAX's SG_FAST=auto: off on the CPU, so fast=True scores
    exactly like the exact path and no top-K context is built."""
    _, tparams, enroll, wavs = iv
    port = _port(tparams, enroll)
    assert port.fast_path is None
    assert port.fast_context(torch.tensor(wavs)) is None
    with torch.no_grad():
        exact = port.score(torch.tensor(wavs)).numpy()
        gated = port.score(torch.tensor(wavs), fast=True).numpy()
    np.testing.assert_array_equal(exact, gated)
    assert _port(tparams, enroll, FastPath(enabled=False)).fast_path is None
    assert _port(tparams, enroll, FastPath()).fast_path == FastPath()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fast_scores_and_grads_match_jax(iv, monkeypatch, config):
    """Fast scores and waveform gradients against JAX's fast path under the
    matching SG_* settings.  Both sides round the same weights and L to
    bf16, and f32 sums run in another order: a sum-order ulp can flip one
    bf16 rounding of L (or, with the stats kernels, of posts16), so scores
    are held at 2e-3 of their spread (measured 1e-5 / 1e-4) and the
    gradient at cosine 0.999 and sign agreement 0.99."""
    jax_model, tparams, enroll, wavs = iv
    fast, env = CONFIGS[config]
    _jax_env(monkeypatch, env)
    x = jnp.asarray(wavs)
    ctx = jax_model.fast_context(x)
    kw = {} if ctx is None else {"fast_ctx": ctx}
    want = np.asarray(jax_model.score(x, fast=True, **kw))
    g_want = np.asarray(jax.grad(
        lambda xx: jnp.sum(jax_model.score(xx, fast=True, **kw)[:, 0]))(x))

    port = _port(tparams, enroll, fast)
    pctx = port.fast_context(torch.tensor(wavs))
    assert (pctx is None) == (ctx is None)
    if ctx is not None:
        _assert_same_selection(pctx.gmm.sel.numpy(), ctx.gmm.sel,
                               jax_model.params.fgmm,
                               jax_model.compute_feat(x, flag=3, fast=True))
    stats_fwd.reset_counts()
    stats_bwd.reset_counts()
    xt = torch.tensor(wavs, requires_grad=True)
    got = port.score(xt, fast=True, fast_ctx=pctx)
    got[:, 0].sum().backward()
    # the kernels run only without a top-K context (JAX gmm.py:616-627)
    n = 1 if fast.stats_kernel else 0
    assert (stats_fwd.plain_calls, stats_bwd.plain_calls) == (n, n)
    spread = float(np.abs(want).max())
    assert np.abs(got.detach().numpy() - want).max() <= 2e-3 * spread
    g = xt.grad.numpy()
    assert _cos(g, g_want) >= 0.999
    nz = np.abs(g_want) > np.abs(g_want).max() * 1e-3
    assert np.mean(np.sign(g[nz]) == np.sign(g_want[nz])) >= 0.99


@pytest.mark.parametrize("fast", [FastPath(gmm_topk=0), KERNELS],
                         ids=["full", "kernels"])
def test_fast_tracks_exact(iv, fast):
    """Mirror of tests/test_fast_path.py:40,52 on the port alone: bf16
    weight copies on a small random fixture keep fast scores within 12% of
    the score spread of the exact ones and the gradient's direction.  (A
    64-of-128 top-K selection drops real mass on this fixture and is held
    to the full fast path by test_topk_full_coverage_tracks_full.)"""
    _, tparams, enroll, wavs = iv
    port = _port(tparams, enroll, fast)
    x = torch.tensor(wavs)
    ctx = port.fast_context(x)
    grads = []
    for fast in (False, True):
        xt = x.clone().requires_grad_(True)
        s = port.score(xt, fast=fast, fast_ctx=ctx if fast else None)
        s[:, 0].sum().backward()
        grads.append(xt.grad.numpy())
        if not fast:
            exact = s.detach().numpy()
    spread = np.abs(exact).max()
    assert np.abs(s.detach().numpy() - exact).max() < 0.12 * max(spread, 1)
    assert _cos(*grads) > 0.8


def test_ivec_l_bf16_scores_and_grads_track(iv):
    """Mirror of tests/test_fast_path.py:195: the bf16 L keeps scores
    within 5% of the spread and the gradient within cosine 0.95 of the f32
    L fast path."""
    _, tparams, enroll, wavs = iv
    out = {}
    for l16 in (False, True):
        port = _port(tparams, enroll, FastPath(gmm_topk=0, ivec_l_bf16=l16))
        xt = torch.tensor(wavs, requires_grad=True)
        s = port.score(xt, fast=True)
        s[:, :2].sum().backward()
        out[l16] = s.detach().numpy(), xt.grad.numpy()
    spread = np.abs(out[False][0]).max()
    assert np.abs(out[True][0] - out[False][0]).max() < 0.05 * max(spread, 1)
    assert _cos(out[True][1], out[False][1]) > 0.95


def test_topk_full_coverage_tracks_full(iv):
    """Mirror of tests/test_fast_path.py:562: with K = C - 1 the selected
    subspace keeps the posterior mass, the stats and the embedding of the
    full fast path."""
    _, tparams, enroll, wavs = iv
    port = _port(tparams, enroll, FastPath())
    feats = port.compute_feat(torch.tensor(wavs), flag=3, fast=True)
    k = tparams.fgmm.num_gaussians - 1
    ctx = make_fast_context(tparams, feats, k)
    assert ctx.gmm.sel.shape == (k,) and ctx.gmm.proj_sel.shape[-1] == k
    with torch.no_grad():
        z_t, _ = TG.zeroth_first_stats(tparams.fgmm, feats, fast=FastPath(),
                                       topk_ctx=ctx.gmm)
        z_f, _ = TG.zeroth_first_stats(tparams.fgmm, feats, fast=FastPath())
        emb_t = embedding_from_cmvn(tparams, feats, fast=FastPath(),
                                    topk_ctx=ctx).numpy()
        emb_f = embedding_from_cmvn(tparams, feats, fast=FastPath()).numpy()
    np.testing.assert_allclose(z_t.sum(-1).numpy(), z_f.sum(-1).numpy(),
                               rtol=1e-3)
    assert np.abs(emb_t - emb_f).max() < 0.05 * max(np.abs(emb_f).max(),
                                                    1e-6)


def test_topk_context_none_when_k_out_of_range(iv):
    """Mirror of tests/test_fast_path.py:516."""
    _, tparams, enroll, wavs = iv
    port = _port(tparams, enroll, FastPath())
    feats = port.compute_feat(torch.tensor(wavs), flag=3, fast=True)
    assert TG.make_topk_context(tparams.fgmm, feats, 128) is None
    assert TG.make_topk_context(tparams.fgmm, feats, 0) is None
    ctx = TG.make_topk_context(tparams.fgmm, feats, 64)
    assert ctx.sel.shape == (64,) and ctx.proj_sel.shape == (2700, 64)
    assert ctx.proj_sel.dtype == torch.bfloat16


def test_topk_stats_match_plain_autodiff_clone(iv):
    """Mirror of tests/test_fast_path.py:527: the selected-subspace stats
    under the hand-written VJP against autograd of a plain clone of the
    same math (selection fixed)."""
    _, tparams, enroll, wavs = iv
    port = _port(tparams, enroll, FastPath())
    p = tparams.fgmm
    feats = port.compute_feat(torch.tensor(wavs), flag=3, fast=True)
    ctx = TG.make_topk_context(p, feats, 48)

    def loss_topk(f):
        z, fs = TG.zeroth_first_stats(p, f, fast=FastPath(), topk_ctx=ctx)
        return (z ** 2).sum() + (fs ** 2).sum()

    def loss_clone(f):
        rows, cols = np.triu_indices(f.shape[-1])
        aug = torch.cat([f, f[..., rows] * f[..., cols]], dim=-1)
        posts = torch.softmax(aug @ ctx.proj_sel.float() + ctx.gconsts_sel,
                              dim=-1)
        return ((posts.sum(-2) ** 2).sum()
                + (torch.einsum("btk,btd->bkd", posts, f) ** 2).sum())

    grads = []
    for fn in (loss_topk, loss_clone):
        f = feats.detach().clone().requires_grad_(True)
        v = fn(f)
        v.backward()
        grads.append((v.item(), f.grad.numpy()))
    (v1, g1), (v2, g2) = grads
    assert abs(v1 - v2) < 1e-3 * max(abs(v2), 1.0)
    assert np.linalg.norm(g1 - g2) / np.linalg.norm(g2) < 1e-4


def test_topk_context_and_stats_match_jax(iv, monkeypatch):
    """make_fast_context against JAX's: the same ranking, and on the port's
    selection the selected-space stats and embedding of both packages at
    f32 round-off (stats) and the score bar of tests/test_torch_iv_plda.py
    (embedding) of one another."""
    from speakerguard_tpu.models import ivector as JIV
    from speakerguard_tpu.models.iv_plda import IvFastContext
    jax_model, tparams, enroll, wavs = iv
    _jax_env(monkeypatch)
    jp = jax_model.params
    jfeats = jax_model.compute_feat(jnp.asarray(wavs), flag=3, fast=True)
    feats = torch.tensor(np.asarray(jfeats))
    ctx = make_fast_context(tparams, feats, 48)
    sel = jnp.asarray(ctx.gmm.sel.numpy())
    _assert_same_selection(sel, jax_make_fast_context(jp, jfeats, 48).gmm.sel,
                           jp.fgmm, jfeats)
    jctx = IvFastContext(
        gmm=JG.GmmTopKContext(sel=sel,
                              proj_sel=jnp.take(JG.fast_proj(jp.fgmm), sel,
                                                axis=1),
                              gconsts_sel=jnp.take(jp.fgmm.gconsts, sel)),
        iv=JIV.make_topk_slices(jp.extractor, sel))
    jz, jf = JG.zeroth_first_stats(jp.fgmm, jfeats, fast=True,
                                   topk_ctx=jctx.gmm)
    with torch.no_grad():
        z, f = TG.zeroth_first_stats(tparams.fgmm, feats, fast=FastPath(),
                                     topk_ctx=ctx.gmm)
        got = embedding_from_cmvn(tparams, feats, fast=FastPath(),
                                  topk_ctx=ctx).numpy()
    # a posterior moves by the f32 round-off of its loglike (sums of 2700
    # terms, loglikes of ~1e3 here): 1e-4 of each statistic's scale
    for a, b in ((z, jz), (f, jf)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    want = np.asarray(jax_embedding_from_cmvn(jp, jfeats, fast=True,
                                              topk_ctx=jctx))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


def test_tchunk_stats_match_unchunked(iv):
    """Mirror of tests/test_fast_path.py:609: chunked stats (a tail chunk,
    a near divisor, one chunk longer than T) match the one-shot block to
    f32 reordering, with and without a top-K context.  The softmax VJP
    subtracts sum_c posts dp from dp where one posterior is ~1, so the
    reordering error of dp (whose terms reach ~10x the gradient) shows at
    1e-3 of the gradient's scale on a few entries."""
    _, tparams, enroll, wavs = iv
    port = _port(tparams, enroll, FastPath())
    p = tparams.fgmm
    feats = port.compute_feat(torch.tensor(wavs), flag=3, fast=True)
    t = feats.shape[1]
    assert t % 7 != 0

    def run(tc, topk_ctx=None):
        f = feats.detach().clone().requires_grad_(True)
        z, fs = TG.zeroth_first_stats(p, f, fast=FastPath(stats_t_chunk=tc),
                                      topk_ctx=topk_ctx)
        v = (z ** 2).sum() + (fs ** 2).sum()
        v.backward()
        return v.item(), f.grad.numpy()

    v0, g0 = run(0)
    for tc in (7, 16, 10 * t):
        v1, g1 = run(tc)
        assert abs(v1 - v0) <= 1e-4 * abs(v0)
        np.testing.assert_allclose(g1, g0, rtol=6e-3,
                                   atol=1e-3 * np.abs(g0).max())
    ctx = TG.make_topk_context(p, feats, 48)
    v0, g0 = run(0, ctx)
    v1, g1 = run(7, ctx)
    assert abs(v1 - v0) <= 1e-4 * abs(v0)
    assert _cos(g0, g1) > 0.99999


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pgd_success_identical_to_jax(iv, monkeypatch, config):
    """PGD with the fast iterations and the exact final evaluation: the
    success vector equals JAX's under the matching SG_* settings (the
    kernel configuration adds the fused loglike on the exact path,
    SG_GMM_PALLAS=1), the output stays in the epsilon ball, and the
    returned success is what the exact model decides on it.  One
    factorization per iteration plus the final one."""
    jax_model, tparams, enroll, _ = iv
    fast, env = CONFIGS[config]
    kernel = fast.stats_kernel
    _jax_env(monkeypatch, {**env, "SG_GMM_PALLAS": "1" if kernel else "0"})
    rng = np.random.default_rng(23)
    batch, eps, step, iters = 4, 0.003, 0.0008, 5
    wavs = rng.uniform(-0.25, 0.25, (batch, 8000)).astype(np.float32)
    labels = rng.integers(0, 5, batch)
    _, want = JaxPGD(jax_model, task="CSI", epsilon=eps, step_size=step,
                     max_iter=iters, loss="Entropy").attack(
        jnp.asarray(wavs), jnp.asarray(labels))
    port = _port(tparams, enroll, fast, loglike_kernel=kernel)
    for w in (cholesky_rt, stats_fwd, stats_bwd, fused_loglike):
        w.reset_counts()
    adver, got = PGD(port, task="CSI", epsilon=eps, step_size=step,
                     max_iter=iters, loss="Entropy").attack(wavs, labels)
    assert got == [bool(s) for s in want]
    assert cholesky_rt.plain_calls == iters + 1
    n = iters if kernel else 0
    assert (stats_fwd.plain_calls, stats_bwd.plain_calls) == (n, n)
    assert fused_loglike.plain_calls == (1 if kernel else 0)
    assert float((adver - torch.tensor(wavs)).abs().max()) <= eps + 1e-6
    with torch.no_grad():
        dec, _ = port.make_decision(adver)
    assert [int(d) != int(y) for d, y in zip(dec, labels)] == got


@pytest.mark.parametrize("cls", [FGSM, CWinf])
def test_fgsm_cwinf_success_identical_to_jax_under_kernels(iv, monkeypatch,
                                                           cls):
    jax_model, tparams, enroll, _ = iv
    _jax_env(monkeypatch, {**CONFIGS["kernels"][1], "SG_GMM_PALLAS": "1"})
    jax_cls = {FGSM: JaxFGSM, CWinf: JaxCWinf}[cls]
    wavs = np.random.default_rng(53).uniform(-0.25, 0.25, (4, 8000)).astype(
        np.float32)
    labels = np.array([4, 3, 2, 1])
    kw = dict(task="CSI", epsilon=0.004)
    if cls is CWinf:
        kw.update(step_size=0.001, max_iter=3)
    _, want = jax_cls(jax_model, **kw).attack(jnp.asarray(wavs),
                                              jnp.asarray(labels))
    port = _port(tparams, enroll, KERNELS, loglike_kernel=True)
    adver, got = cls(port, **kw).attack(wavs, labels)
    assert got == [bool(s) for s in want]
    assert float((adver - torch.tensor(wavs)).abs().max()) <= 0.004 + 1e-6


def test_convert_carries_bf16_copies_as_jax_rounds_them(iv):
    """The bf16 copies are the carried float32 tensors rounded to bf16,
    bit-equal to the JAX package's own copies; absent on the CPU unless the
    JAX tree holds them or fast_copies asks."""
    from speakerguard_tpu.models import ivector as JIV
    jax_model, tparams, _, _ = iv
    assert tparams.fgmm.quad_proj_bf16 is None
    assert tparams.extractor.quad_packed_bf16 is None
    jp = jax_model.params
    for tree_has in (False, True):
        tree = jax.tree.map(np.asarray, jp)
        kw = {"fast_copies": True}
        if tree_has:
            tree = tree._replace(
                fgmm=tree.fgmm._replace(quad_proj_bf16=np.asarray(
                    JG.fast_proj(jp.fgmm).astype(jnp.float32))),
                extractor=tree.extractor._replace(
                    quad_packed_bf16=np.asarray(JIV._fast_quad(
                        jp.extractor).astype(jnp.float32)),
                    proj_bf16=np.asarray(JIV._fast_proj(
                        jp.extractor).astype(jnp.float32))))
            kw = {}
        got = from_jax_params(tree, device="cpu", **kw)
        for ours, theirs in (
                (got.fgmm.quad_proj_bf16, JG.fast_proj(jp.fgmm)),
                (got.extractor.quad_packed_bf16,
                 JIV._fast_quad(jp.extractor)),
                (got.extractor.proj_bf16, JIV._fast_proj(jp.extractor))):
            assert ours.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)))


def test_package_turns_off_reduced_precision_bf16_reductions():
    """JAX's preferred_element_type=float32 accumulates bf16 products in
    float32; importing the port keeps cuBLAS from reducing bf16 GEMMs in
    reduced precision, and TF32 off."""
    import speakerguard_tpu_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# The i-vector solve's other kernels (IvPlda spd_solver=...) on the top-K
# fast path against JAX's under the matching SG_CHOL_* settings.  The fast
# path's bf16 L goes to cholesky_rt_dinv as it is, with bf16 updates, and
# to chol_solve converted to float32 (JAX ivector.py:159-166, :224-228).
@pytest.mark.parametrize("solver", ["chol_solve", "cholesky_rt_dinv"])
def test_spd_solver_fast_scores_and_grads_match_jax(iv, monkeypatch,
                                                    solver):
    """Fast scores and waveform gradients as in
    test_fast_scores_and_grads_match_jax, under each solver."""
    jax_model, tparams, enroll, wavs = iv
    fast, env = CONFIGS["topk"]
    _jax_env(monkeypatch, {**env, **JAX_SOLVER_ENV[solver],
                           "SG_CHOL_BTILE": "3"})
    x = jnp.asarray(wavs)
    ctx = jax_model.fast_context(x)
    want = np.asarray(jax_model.score(x, fast=True, fast_ctx=ctx))
    g_want = np.asarray(jax.grad(lambda xx: jnp.sum(
        jax_model.score(xx, fast=True, fast_ctx=ctx)[:, 0]))(x))
    port = IvPlda(tparams, mfcc_config=dataclasses.replace(IV_PLDA_MFCC,
                                                           dither=0.0),
                  fast=fast, spd_solver=solver)
    port.set_enrollment([str(i) for i in range(5)], enroll)
    pctx = port.fast_context(torch.tensor(wavs))
    wrapper = getattr(chol, solver)
    wrapper.reset_counts()
    cholesky_rt.reset_counts()
    xt = torch.tensor(wavs, requires_grad=True)
    got = port.score(xt, fast=True, fast_ctx=pctx)
    got[:, 0].sum().backward()
    assert wrapper.plain_calls == (2 if solver == "chol_solve" else 1)
    assert cholesky_rt.plain_calls == 0
    spread = float(np.abs(want).max())
    assert np.abs(got.detach().numpy() - want).max() <= 2e-3 * spread
    g = xt.grad.numpy()
    assert _cos(g, g_want) >= 0.999
    nz = np.abs(g_want) > np.abs(g_want).max() * 1e-3
    assert np.mean(np.sign(g[nz]) == np.sign(g_want[nz])) >= 0.99


@pytest.mark.parametrize("solver", ["chol_solve", "cholesky_rt_dinv"])
def test_spd_solver_fast_pgd_success_identical_to_jax(iv, monkeypatch,
                                                      solver):
    """PGD on the top-K fast path with the exact final evaluation, under
    each solver: JAX's success vector, the epsilon ball, and the kernel
    once per iteration (twice for chol_solve) plus the final evaluation."""
    jax_model, tparams, enroll, _ = iv
    fast, env = CONFIGS["topk"]
    _jax_env(monkeypatch, {**env, **JAX_SOLVER_ENV[solver],
                           "SG_CHOL_BTILE": "4"})
    rng = np.random.default_rng(23)
    batch, eps, step, iters = 4, 0.003, 0.0008, 5
    wavs = rng.uniform(-0.25, 0.25, (batch, 8000)).astype(np.float32)
    labels = rng.integers(0, 5, batch)
    _, want = JaxPGD(jax_model, task="CSI", epsilon=eps, step_size=step,
                     max_iter=iters, loss="Entropy").attack(
        jnp.asarray(wavs), jnp.asarray(labels))
    port = IvPlda(tparams, mfcc_config=dataclasses.replace(IV_PLDA_MFCC,
                                                           dither=0.0),
                  fast=fast, spd_solver=solver)
    port.set_enrollment([str(i) for i in range(5)], enroll)
    wrapper = getattr(chol, solver)
    wrapper.reset_counts()
    cholesky_rt.reset_counts()
    adver, got = PGD(port, task="CSI", epsilon=eps, step_size=step,
                     max_iter=iters, loss="Entropy").attack(wavs, labels)
    assert got == [bool(s) for s in want]
    per_iter = 2 if solver == "chol_solve" else 1
    assert wrapper.plain_calls == per_iter * iters + 1
    assert cholesky_rt.plain_calls == 0
    assert float((adver - torch.tensor(wavs)).abs().max()) <= eps + 1e-6
