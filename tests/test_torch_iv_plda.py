"""The port's iv-PLDA slice against the JAX package, on the same weights.

Weights are drawn once with numpy through the JAX package's
random_iv_plda_params and carried across with convert.from_jax_params, so
both packages compute from identical float32 numbers.  Sizes follow the
iv_pair fixture of test_parity_torch.py: C=64, D=72, IV=32, R=16, 8000-sample
waves, dither 0 (the two frameworks draw different dither noise).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import PGD as JaxPGD
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import (
    load_iv_plda_params as jax_load_iv_plda_params, random_iv_plda_params)
from speakerguard_tpu.ops.kaldi_mfcc import IV_PLDA_MFCC as JAX_IV_MFCC

from speakerguard_tpu_torch.attacks import PGD, FGSM, CWinf
from speakerguard_tpu_torch.attacks.losses import cross_entropy_loss
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models.iv_plda import IvPlda, load_iv_plda_params
from speakerguard_tpu_torch.ops import chol
from speakerguard_tpu_torch.ops.chol import cholesky_rt
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC

from test_torch_chol_family import _jax_env as _jax_solver_env

# Score tolerance: the bar test_parity_torch.py already holds the JAX scores
# to (O(10) PLDA scores; f32 sums in a different order through a 64-component
# GMM, a 32-dim solve and the PLDA chain).
SCORE_TOL = dict(rtol=1e-3, atol=5e-3)


@pytest.fixture(scope="module")
def iv_models():
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=32, reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    jax_model = JaxIvPlda(params, mfcc_config=dataclasses.replace(
        JAX_IV_MFCC, dither=0.0))
    jax_model.set_enrollment([str(i) for i in range(5)], enroll)
    port = IvPlda(from_jax_params(jax.tree.map(np.asarray, params),
                                  device="cpu"),
                  mfcc_config=dataclasses.replace(IV_PLDA_MFCC, dither=0.0))
    port.set_enrollment([str(i) for i in range(5)], enroll)
    return jax_model, port


def _wavs(seed, b=3, scale=0.25):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (b, 8000)).astype(np.float32)


@pytest.mark.parametrize("flag", [1, 2, 3])
def test_compute_feat_matches_jax(iv_models, flag):
    jax_model, port = iv_models
    wavs = _wavs(5)
    want = np.asarray(jax_model.compute_feat(jnp.asarray(wavs), flag=flag))
    got = port.compute_feat(torch.tensor(wavs), flag=flag).numpy()
    assert got.shape == want.shape
    # f32 frontend against f32 frontend: same DFT matrices, different sum
    # order; MFCC magnitudes reach ~1e2, so an absolute floor of 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("flag", [0, 1, 2, 3])
def test_embedding_and_score_match_jax(iv_models, flag):
    jax_model, port = iv_models
    wavs = _wavs(17)
    x = (wavs if flag == 0 else
         np.asarray(jax_model.compute_feat(jnp.asarray(wavs), flag=flag)))
    want_emb = np.asarray(jax_model.embedding(jnp.asarray(x), flag=flag))
    want = np.asarray(jax_model.score(jnp.asarray(x), flag=flag))
    with torch.no_grad():
        got_emb = port.embedding(torch.tensor(x), flag=flag).numpy()
        got = port.score(torch.tensor(x), flag=flag).numpy()
    assert got.shape == want.shape == (3, 5)
    # embeddings are length-normalized to norm sqrt(R)=4: same bar as scores
    np.testing.assert_allclose(got_emb, want_emb, **SCORE_TOL)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_make_decision_matches_jax(iv_models):
    jax_model, port = iv_models
    wavs = _wavs(29, b=6)
    want_dec, want = jax_model.make_decision(jnp.asarray(wavs))
    with torch.no_grad():
        got_dec, got = port.make_decision(torch.tensor(wavs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    assert got_dec.tolist() == np.asarray(want_dec).tolist()


def test_ce_input_gradient_matches_jax(iv_models):
    jax_model, port = iv_models
    wavs = _wavs(41, b=4)
    labels = np.array([0, 1, 2, 3])
    from speakerguard_tpu.attacks.losses import cross_entropy_loss as jax_ce

    def jloss(x):
        return jnp.sum(jax_ce(jax_model.score(x), jnp.asarray(labels)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(wavs))).ravel()
    x = torch.tensor(wavs, requires_grad=True)
    cross_entropy_loss(port.score(x), torch.tensor(labels)).sum().backward()
    got = x.grad.numpy().ravel()
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    # sign() consumes the gradient: the bar is direction and sign agreement
    assert cos >= 0.999
    assert np.mean(np.sign(got) == np.sign(want)) >= 0.99


def test_pgd_success_vector_identical_to_jax(iv_models):
    """Same weights, inputs and hyperparameters as test_parity_torch.py::
    test_iv_plda_pgd_asr_parity: the per-sample success vectors must be
    identical, and the SPD solve factorizes exactly once per iteration
    (forward + backward) plus once for the final exact evaluation."""
    jax_model, port = iv_models
    rng = np.random.default_rng(23)
    batch, eps, step, iters = 4, 0.003, 0.0008, 8
    wavs = rng.uniform(-0.25, 0.25, (batch, 8000)).astype(np.float32)
    labels = rng.integers(0, 5, batch)
    _, want = JaxPGD(jax_model, task="CSI", epsilon=eps, step_size=step,
                     max_iter=iters, loss="Entropy").attack(
        jnp.asarray(wavs), jnp.asarray(labels))
    cholesky_rt.reset_counts()
    adver, got = PGD(port, task="CSI", epsilon=eps, step_size=step,
                     max_iter=iters, loss="Entropy",
                     num_random_init=0).attack(wavs, labels)
    assert got == [bool(s) for s in want]
    assert cholesky_rt.plain_calls == iters + 1
    assert adver.shape == wavs.shape
    assert float((adver - torch.tensor(wavs)).abs().max()) <= eps + 1e-6


@pytest.mark.parametrize("cls", [FGSM, CWinf])
def test_fgsm_cwinf_success_identical_to_jax(iv_models, cls):
    from speakerguard_tpu.attacks import FGSM as JaxFGSM, CWinf as JaxCWinf
    jax_cls = {FGSM: JaxFGSM, CWinf: JaxCWinf}[cls]
    jax_model, port = iv_models
    wavs = _wavs(53, b=4)
    labels = np.array([4, 3, 2, 1])
    kw = dict(task="CSI", epsilon=0.004)
    if cls is CWinf:
        kw.update(step_size=0.001, max_iter=3)
    _, want = jax_cls(jax_model, **kw).attack(jnp.asarray(wavs),
                                              jnp.asarray(labels))
    _, got = cls(port, **kw).attack(wavs, labels)
    assert got == [bool(s) for s in want]


def test_kaldi_artifacts_load_matches_jax(tmp_path):
    from fixtures import make_small_iv_artifacts
    paths, _ = make_small_iv_artifacts(str(tmp_path),
                                       np.random.default_rng(3))
    files = [paths[k] for k in ("gmm", "extractor", "plda", "mean",
                                "transform")]
    jax_model = JaxIvPlda(jax_load_iv_plda_params(*files),
                          mfcc_config=dataclasses.replace(JAX_IV_MFCC,
                                                          num_ceps=8,
                                                          dither=0.0))
    port = IvPlda(load_iv_plda_params(*files, device="cpu"),
                  mfcc_config=dataclasses.replace(IV_PLDA_MFCC, num_ceps=8,
                                                  dither=0.0))
    enroll = np.random.default_rng(4).standard_normal((3, 8))
    jax_model.set_enrollment(["a", "b", "c"], enroll)
    port.set_enrollment(["a", "b", "c"], enroll)
    wavs = _wavs(61)
    want = np.asarray(jax_model.score(jnp.asarray(wavs)))
    with torch.no_grad():
        got = port.score(torch.tensor(wavs)).numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_gmm_stats_and_ivector_extraction_match_jax():
    """Module level: the port's own load-time precomputes (build_gmm,
    build_extractor) against the JAX ones, and stats -> i-vectors on the
    carried-across weights."""
    from speakerguard_tpu.models import gmm as jgmm, ivector as jiv
    from speakerguard_tpu_torch.models import gmm as tgmm, ivector as tiv
    rng = np.random.default_rng(7)
    jg = jgmm.random_gmm(np.random.default_rng(8), 32, 12)
    tg = tgmm.random_gmm(np.random.default_rng(8), 32, 12, device="cpu")
    np.testing.assert_allclose(tg.quad_proj.numpy(), np.asarray(jg.quad_proj),
                               rtol=1e-6, atol=1e-6)
    je = jiv.random_extractor(np.random.default_rng(9), 32, 12, 20)
    te = tiv.random_extractor(np.random.default_rng(9), 32, 12, 20,
                              device="cpu")
    # f32 einsum precompute in both packages (sum order differs)
    np.testing.assert_allclose(te.quad_packed.numpy(),
                               np.asarray(je.quad_packed), rtol=1e-5,
                               atol=1e-6)
    feats = rng.standard_normal((3, 50, 12)).astype(np.float32)
    jz, jf = jgmm.zeroth_first_stats(jg, jnp.asarray(feats))
    tz, tf = tgmm.zeroth_first_stats(tg, torch.tensor(feats))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-4)
    want = np.asarray(jiv.extract_ivectors(je, jz, jf))
    got = tiv.extract_ivectors(te, tz, tf).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# The i-vector solve's other kernels (IvPlda spd_solver=...) against JAX under
# the matching SG_CHOL_* settings: the Pallas kernels in interpret mode with
# the port's panel size, batch tiles of the test batch.
NEW_SOLVERS = ["chol_solve", "cholesky_rt_dinv"]


def _solver_port(port, solver):
    model = IvPlda(port.params, mfcc_config=port.mfcc_config,
                   spd_solver=solver)
    model.set_enrollment(port.spk_ids, port.enroll_embs)
    return model


@pytest.mark.parametrize("solver", NEW_SOLVERS)
def test_spd_solver_scores_and_grad_match_jax(iv_models, monkeypatch,
                                              solver):
    """Scores at the score bar and the CE input gradient at the direction
    bar of the default solver's tests; one kernel call per forward, and for
    chol_solve one more per backward."""
    jax_model, port = iv_models
    wavs = _wavs(43, b=4)
    labels = np.array([0, 1, 2, 3])
    _jax_solver_env(monkeypatch, solver, 4)
    from speakerguard_tpu.attacks.losses import cross_entropy_loss as jax_ce
    want = np.asarray(jax_model.score(jnp.asarray(wavs)))
    g_want = np.asarray(jax.grad(lambda x: jnp.sum(jax_ce(
        jax_model.score(x), jnp.asarray(labels))))(jnp.asarray(wavs)))
    model = _solver_port(port, solver)
    wrapper = getattr(chol, solver)
    cholesky_rt.reset_counts()
    wrapper.reset_counts()
    x = torch.tensor(wavs, requires_grad=True)
    got = model.score(x)
    cross_entropy_loss(got, torch.tensor(labels)).sum().backward()
    assert wrapper.plain_calls == (2 if solver == "chol_solve" else 1)
    assert cholesky_rt.plain_calls == 0
    np.testing.assert_allclose(got.detach().numpy(), want, **SCORE_TOL)
    g = x.grad.numpy().ravel()
    g_want = g_want.ravel()
    assert g @ g_want / (np.linalg.norm(g) * np.linalg.norm(g_want)) >= 0.999
    assert np.mean(np.sign(g) == np.sign(g_want)) >= 0.99


@pytest.mark.parametrize("solver", NEW_SOLVERS)
def test_spd_solver_pgd_success_identical_to_jax(iv_models, monkeypatch,
                                                 solver):
    """The PGD of test_pgd_success_vector_identical_to_jax under each
    solver: identical success vectors; the kernel runs once per iteration
    (twice for chol_solve, whose backward solves again) plus once for the
    final evaluation, and cholesky_rt never."""
    jax_model, port = iv_models
    rng = np.random.default_rng(23)
    batch, eps, step, iters = 4, 0.003, 0.0008, 8
    wavs = rng.uniform(-0.25, 0.25, (batch, 8000)).astype(np.float32)
    labels = rng.integers(0, 5, batch)
    _jax_solver_env(monkeypatch, solver, batch)
    _, want = JaxPGD(jax_model, task="CSI", epsilon=eps, step_size=step,
                     max_iter=iters, loss="Entropy").attack(
        jnp.asarray(wavs), jnp.asarray(labels))
    wrapper = getattr(chol, solver)
    cholesky_rt.reset_counts()
    wrapper.reset_counts()
    adver, got = PGD(_solver_port(port, solver), task="CSI", epsilon=eps,
                     step_size=step, max_iter=iters, loss="Entropy",
                     num_random_init=0).attack(wavs, labels)
    assert got == [bool(s) for s in want]
    per_iter = 2 if solver == "chol_solve" else 1
    assert wrapper.plain_calls == per_iter * iters + 1
    assert cholesky_rt.plain_calls == 0
    assert float((adver - torch.tensor(wavs)).abs().max()) <= eps + 1e-6


@pytest.mark.parametrize("solver", NEW_SOLVERS)
@pytest.mark.parametrize("cls", [FGSM, CWinf])
def test_spd_solver_fgsm_cwinf_success_identical_to_jax(iv_models,
                                                        monkeypatch, solver,
                                                        cls):
    from speakerguard_tpu.attacks import FGSM as JaxFGSM, CWinf as JaxCWinf
    jax_cls = {FGSM: JaxFGSM, CWinf: JaxCWinf}[cls]
    jax_model, port = iv_models
    wavs = _wavs(53, b=4)
    labels = np.array([4, 3, 2, 1])
    kw = dict(task="CSI", epsilon=0.004)
    if cls is CWinf:
        kw.update(step_size=0.001, max_iter=3)
    _jax_solver_env(monkeypatch, solver, 4)
    _, want = jax_cls(jax_model, **kw).attack(jnp.asarray(wavs),
                                              jnp.asarray(labels))
    _, got = cls(_solver_port(port, solver), **kw).attack(wavs, labels)
    assert got == [bool(s) for s in want]


def test_spd_solver_rejects_unknown(iv_models):
    _, port = iv_models
    with pytest.raises(ValueError):
        IvPlda(port.params, spd_solver="lapack")
