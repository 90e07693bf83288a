"""The port's DefendedModel and the BPDA+EOT PGD through it against the JAX
package (speakerguard_tpu/models/defended.py, BASELINE.json config 5), on
small iv-PLDA (C=64, D=72, IV=32, R=16, 8000-sample waves, as
tests/test_torch_tasks.py) and xv-PLDA (full TDNN widths, 16000-sample
waves, as tests/test_torch_xv_plda.py), with the same weights carried across
by convert.from_jax_params.

Randomness: FeCo's initial frames are drawn by JAX and passed into the
port through ``DefendedModel(draw_fn=)``.  The JAX schedule is rebuilt here
with jax.random (speakerguard_tpu/attacks/gradient.py:93-114 and
models/defended.py:24-27,77): the attack's key splits into the init and
loop keys, the loop key into (max_iter + 1) x EOT keys, each repeat's key
into one key per defense, FeCo's key into one per row, and each row draws
``permutation(key, T)``, whose first K frames are its initial centres; the
final evaluation uses keys[max_iter, 0].
The port's PGD consumes them in that order (iteration by iteration, repeat
by repeat, then the final evaluation), and each test checks that it took
every draw.

Bars: scores at each model's bar (iv rtol 1e-3 / atol 5e-3, xv rtol 1e-4 /
atol 2e-3, as tests/test_torch_tasks.py); decisions and PGD success vectors
identical to JAX's.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import PGD as JaxPGD
from speakerguard_tpu.defenses.registry import parser_defense as jax_parser
from speakerguard_tpu.models.defended import DefendedModel as JaxDefended
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import random_iv_plda_params
from speakerguard_tpu.models.xv_plda import XvPlda as JaxXvPlda
from speakerguard_tpu.models.xv_plda import random_xv_plda_params

from speakerguard_tpu_torch import bench
from speakerguard_tpu_torch.attacks import PGD
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.defenses.registry import parser_defense
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.models.defended import DefendedModel
from speakerguard_tpu_torch.models.iv_plda import IvPlda
from speakerguard_tpu_torch.models.xv_plda import XvPlda

SCORE_TOL = {"iv": dict(rtol=1e-3, atol=5e-3),
             "xv": dict(rtol=1e-4, atol=2e-3)}
SPK = [str(i) for i in range(5)]
QT_FECO = (["QT", "FeCo"], ["512", "kmeans 0.5 L2"], [0, 1])


@pytest.fixture(scope="module")
def worlds():
    """{kind: (JAX model, port model, waves)}, waves of rising amplitude
    (the epsilon ball is larger for the quieter ones after CMVN)."""
    out = {}
    rng = np.random.default_rng(99)
    iv = random_iv_plda_params(rng, num_gaussians=64, dim=72, ivector_dim=32,
                               reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    out["iv"] = (JaxIvPlda(iv), IvPlda(from_jax_params(
        jax.tree.map(np.asarray, iv), device="cpu")), enroll, 8000)
    rng = np.random.default_rng(1234)
    xv = random_xv_plda_params(rng)
    pm = XvPlda(from_jax_params(jax.tree.map(np.asarray, xv), device="cpu"))
    # speakers near the waves' own embeddings (plus a little spread), so
    # that the defended decisions have margins an epsilon ball can cross
    enroll_wavs = (np.random.default_rng(3).uniform(-1, 1, (5, 16000))
                   * np.array([0.03, 0.06, 0.1, 0.2, 0.3])[:, None])
    with torch.no_grad():
        enroll = pm.embedding(torch.tensor(enroll_wavs, dtype=torch.float32))
    enroll = (enroll.numpy() + 0.1 * rng.standard_normal((5, 150))).astype(
        np.float32)
    out["xv"] = (JaxXvPlda(xv), pm, enroll, 16000)
    worlds = {}
    for kind, (jm, pm, enroll, length) in out.items():
        jm.set_enrollment(SPK, enroll)
        pm.set_enrollment(SPK, enroll)
        scale = np.array([0.02, 0.05, 0.1, 0.15, 0.2, 0.3])[:, None]
        wavs = (np.random.default_rng(11).uniform(-1, 1, (6, length))
                * scale).astype(np.float32)
        worlds[kind] = (jm, pm, wavs)
    return worlds


def _models(world, names, params, flags, order, draws=None):
    jm, pm, _ = world
    jd, jname = jax_parser(names, params, flags, order)
    d, name = parser_defense(names, params, flags, order)
    assert name == jname
    return (JaxDefended(jm, defense=jd, order=order),
            DefendedModel(pm, defense=d, order=order, draw_fn=draws))


def _frames(pm, wavs):
    with torch.no_grad():
        return pm.compute_feat(torch.tensor(wavs[:1]), flag=1).shape[1]


def _rows(key, b, t):
    """FeCo's JAX draw for one defense key: a permutation per row."""
    return np.array(jax.vmap(lambda kk: jax.random.permutation(kk, t))(
        jax.random.split(key, b)))


class Draws:
    """A draw_fn handing out JAX-drawn FeCo frame orders in order."""

    def __init__(self, values=()):
        self.values = list(values)

    def __call__(self, kind, shape):
        assert kind == "kmeans_init"
        v = self.values.pop(0)
        assert v.shape == shape
        return v


def _feco_rows(key, n_defenses, pos, b, t):
    """The rows FeCo (the ``pos``-th defense applied) draws under ``key``
    (None: JAX's PRNGKey(0) fallback)."""
    if key is None:
        return _rows(jax.random.PRNGKey(0), b, t)
    return _rows(jax.random.split(key, n_defenses)[pos], b, t)


def _pgd_schedule(key, max_iter, eot, b, t, n_defenses=2, pos=1):
    _, loop_key = jax.random.split(key)
    keys = jax.random.split(loop_key, (max_iter + 1) * eot).reshape(
        max_iter + 1, eot, 2)
    order = [keys[i, e] for i in range(max_iter) for e in range(eot)]
    return [_feco_rows(k, n_defenses, pos, b, t)
            for k in order + [keys[max_iter, 0]]]


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_sequential_qt_feco_scores_match_jax(worlds, kind):
    jm, pm, wavs = worlds[kind]
    key = jax.random.PRNGKey(4)
    t = _frames(pm, wavs)
    draws = Draws([_feco_rows(key, 2, 1, len(wavs), t),
                   _feco_rows(None, 2, 1, len(wavs), t)])
    jd, dm = _models(worlds[kind], *QT_FECO, "sequential", draws)
    with torch.no_grad():
        got = dm.score(torch.tensor(wavs)).numpy()
        dec = dm.make_decision(torch.tensor(wavs))[0].numpy()
    assert draws.values == []
    np.testing.assert_allclose(got, np.asarray(jd.score(
        jnp.asarray(wavs), rng=key)), **SCORE_TOL[kind])
    np.testing.assert_array_equal(dec, np.asarray(jd.make_decision(
        jnp.asarray(wavs))[0]))


def test_feco_at_the_delta_level_matches_jax(worlds):
    """iv's flag 2 (raw MFCC + deltas): FeCo between delta and CMVN."""
    jm, pm, wavs = worlds["iv"]
    key = jax.random.PRNGKey(6)
    t = _frames(pm, wavs)
    args = (["QT", "FeCo"], ["512", "kmeans 0.5 cos"], [0, 2])
    draws = Draws([_feco_rows(key, 2, 1, len(wavs), t)])
    jd, dm = _models(worlds["iv"], *args, "sequential", draws)
    with torch.no_grad():
        got = dm.embedding(torch.tensor(wavs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jd.embedding(
        jnp.asarray(wavs), rng=key)), **SCORE_TOL["iv"])


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_average_order_matches_jax(worlds, kind):
    jm, pm, wavs = worlds[kind]
    key = jax.random.PRNGKey(8)
    t = _frames(pm, wavs)
    args = (["QT", "AS", "FeCo"], ["512", "3", "kmeans 0.5 L2"], [0, 0, 1])
    draws = Draws([_feco_rows(key, 3, 2, len(wavs), t)] * 2)
    jd, dm = _models(worlds[kind], *args, "average", draws)
    with torch.no_grad():
        scores, emb = dm.forward(torch.tensor(wavs), return_emb=True)
        only_emb = dm.embedding(torch.tensor(wavs)).numpy()
    want, want_emb = jd.forward(jnp.asarray(wavs), return_emb=True, rng=key)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want),
                               **SCORE_TOL[kind])
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb),
                               **SCORE_TOL[kind])
    np.testing.assert_allclose(only_emb, emb.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_no_defense_equals_the_base(worlds, kind):
    _, pm, wavs = worlds[kind]
    dm = DefendedModel(pm)
    x = torch.tensor(wavs)
    with torch.no_grad():
        torch.testing.assert_close(dm.score(x), pm.score(x), rtol=0, atol=0)
        torch.testing.assert_close(dm.make_decision(x)[0],
                                   pm.make_decision(x)[0])
    assert dm.num_defenses == 0 and dm.device == pm.device


def test_the_wrapper_follows_its_base(worlds):
    _, pm, _ = worlds["xv"]
    dm = DefendedModel(pm, *parser_defense(*QT_FECO, "sequential")[:1])
    assert dm.base_model is pm
    assert list(dm.children()) == [pm]
    assert (dm.allowed_flags, dm.spk_ids, dm.threshold, dm.num_spks) == (
        pm.allowed_flags, pm.spk_ids, pm.threshold, 5)
    assert sorted(dm.flag2defense) == [0, 1, 2]
    with pytest.warns(UserWarning, match="Unsupported"):
        DefendedModel(pm, *parser_defense(["QT"], ["512"], [7],
                                          "sequential")[:1])
    with pytest.raises(ValueError):
        DefendedModel(pm, *parser_defense(["QT"], ["512"], [0],
                                          "sequential")[:1], order="mean")


def test_fast_context_is_none(worlds):
    """The JAX wrapper inherits the base protocol's None, so iv-PLDA's fast
    path runs over every Gaussian under a defense, even with top-K on."""
    _, pm, wavs = worlds["iv"]
    base = IvPlda(pm.params, fast=FastPath(gmm_topk=8))
    base.set_enrollment(SPK, pm.enroll_embs)
    assert base.fast_context(torch.tensor(wavs)) is not None
    dm = DefendedModel(base, *parser_defense(*QT_FECO, "sequential")[:1])
    assert dm.fast_context(torch.tensor(wavs)) is None
    assert dm.fast_path == base.fast_path


ATTACK = {"iv": dict(epsilon=0.0005, step_size=0.000125, max_iter=4),
          "xv": dict(epsilon=0.01, step_size=0.0025, max_iter=4)}


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_pgd_eot2_through_qt_feco_matches_jax(worlds, kind):
    """BASELINE.json config 5 at a small size: BPDA (straight-through QT)
    + EOT 2 PGD against QT + FeCo, the clean decisions as labels."""
    jm, pm, wavs = worlds[kind]
    b, t, kw = len(wavs), _frames(pm, wavs), ATTACK[kind]
    key = jax.random.PRNGKey(21)
    draws = Draws([_feco_rows(None, 2, 1, b, t)])
    jd, dm = _models(worlds[kind], *QT_FECO, "sequential", draws)
    labels = np.array(jd.make_decision(jnp.asarray(wavs))[0])
    with torch.no_grad():
        np.testing.assert_array_equal(
            dm.make_decision(torch.tensor(wavs))[0].numpy(), labels)
    _, want = JaxPGD(jd, task="CSI", EOT_size=2, **kw).attack(
        jnp.asarray(wavs), jnp.asarray(labels), rng=key)
    draws.values = _pgd_schedule(key, kw["max_iter"], 2, b, t)
    adver, got = PGD(dm, task="CSI", EOT_size=2, **kw).attack(wavs, labels)
    assert draws.values == []
    assert got == [bool(s) for s in want]
    assert 0 < sum(got) < b
    assert float((adver - torch.tensor(wavs)).abs().max()) <= (
        kw["epsilon"] + 1e-6)


def test_bench_entry_with_a_defense(worlds, capsys):
    """python -m speakerguard_tpu_torch.bench --defense FeCo --eot 2 on the
    CPU at a tiny size: the JAX bench's metric name."""
    assert bench.main(["--device", "cpu", "--batch", "2", "--wav-len",
                       "32000", "--iters", "1", "--warmup", "0", "--reps",
                       "1", "--defense", "FeCo", "--eot", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "pgd1_xv_plda_FeCo_eot2_utts_per_sec"
    assert rec["defense"] == "FeCo" and rec["eot"] == 2
    assert rec["value"] > 0 and rec["fast_path"] is None
    model, tag = bench.defend(worlds["xv"][1], bench.parse_args(
        ["--defense", "QT,FeCo", "--defense-param", "256|kmeans 0.5 cos"]))
    assert tag == "_QT-FeCo"
    assert [f for f, _ in model.defense] == [0, 1]
