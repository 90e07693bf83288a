"""The port's PGD with the JAX package's draws passed in: the dithered
frontend, the restart noise, and targeted PGD on iv-PLDA and xv-PLDA.

Worlds as tests/test_torch_defended.py's (small iv-PLDA: C=64, D=72, IV=32,
R=16, 8000-sample waves; xv-PLDA at full TDNN widths, 16000-sample waves;
the same weights carried across by convert.from_jax_params), but with each
model's default MFCC dither of 1.0, so every score of an attack draws
noise.  JAX's schedule (speakerguard_tpu/attacks/gradient.py:93-103,136)
is rebuilt here with jax.random and handed to the port through
``PGD(init_noise_fn=, dither_fn=)``: with restarts the attack key splits
into one key per restart; a restart's key splits into the init and loop
keys; the init noise is ``uniform(init_key, shape, -eps, eps)``; the loop
key splits into (max_iter + 1) x EOT dither keys, and each score draws
``normal(keys[it, e], frames.shape)`` (ops/kaldi_mfcc.py:347-348), the
final evaluation keys[max_iter, 0].

Bars: per-sample success vectors identical to JAX's.  Success alone
hardly sees the draws (a run on the port's own draws gave the same vectors
here), so the audio is held too, where a sign step has no earlier flips to
follow: after one dithered step at least 99.5% of the samples, and after
three restarts at least 95%, within 1e-6 of JAX's (the port's own draws:
98.2-98.6% and 7-9%); and one dithered score within 2e-5 of the largest
score (iv's without JAX's draw: 0.13 apart at 9.1).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import PGD as JaxPGD
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import random_iv_plda_params
from speakerguard_tpu.models.xv_plda import XvPlda as JaxXvPlda
from speakerguard_tpu.models.xv_plda import random_xv_plda_params

from speakerguard_tpu_torch.attacks import PGD
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.defenses.registry import parser_defense
from speakerguard_tpu_torch.models.defended import DefendedModel
from speakerguard_tpu_torch.models.iv_plda import IvPlda
from speakerguard_tpu_torch.models.xv_plda import XvPlda
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC, kaldi_mfcc

from test_torch_kenan import one_cpu_thread  # noqa: F401

SPK = [str(i) for i in range(5)]


class JaxPgdDraws:
    """The draws of JAX's PGD under attack key ``key``, as the port's two
    hooks.  ``calls`` counts the dither draws handed out."""

    def __init__(self, key, epsilon, max_iter, eot_size=1,
                 num_random_init=0):
        restart_keys = (jax.random.split(key, num_random_init)
                        if num_random_init > 1 else [key])
        self.epsilon = epsilon
        self.init_keys, self.dither_keys = [], []
        for rk in restart_keys:
            init_key, loop_key = jax.random.split(rk)
            self.init_keys.append(init_key)
            self.dither_keys.append(jax.random.split(
                loop_key, (max_iter + 1) * eot_size).reshape(
                    max_iter + 1, eot_size, 2))
        self.calls = 0

    def init_noise_fn(self, restart, shape):
        return np.asarray(jax.random.uniform(
            self.init_keys[restart], shape, jnp.float32, -self.epsilon,
            self.epsilon))

    def dither_fn(self, restart, it, e, shape):
        self.calls += 1
        return np.asarray(jax.random.normal(
            self.dither_keys[restart][it, e], shape, jnp.float32))

    def hooks(self):
        return dict(init_noise_fn=self.init_noise_fn,
                    dither_fn=self.dither_fn)


@pytest.fixture(scope="module")
def worlds():
    """{kind: (JAX model, port model, waves, clean JAX decisions)}, waves
    of rising amplitude, the default dither on both sides."""
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
        labels = np.asarray(jm.make_decision(jnp.asarray(wavs))[0])
        worlds[kind] = (jm, pm, wavs, labels)
    return worlds


# (epsilon, step) of each world: PGD's defaults (0.002, 0.0004) carry every
# wave of these random models across, so balls that some waves cross and
# others do not, untargeted and targeted
ATTACK = {"iv": dict(epsilon=0.0002, step_size=0.00004),
          "xv": dict(epsilon=0.004, step_size=0.001)}
TARGETED = {"iv": dict(epsilon=0.0005, step_size=0.0001),
            "xv": dict(epsilon=0.004, step_size=0.001)}


def _run_both(world, kind, key, targeted=False, labels=None, **kw):
    """JAX's PGD under ``key`` and the port's with JAX's draws; returns
    (JAX's success, the port's, the draws, the share of samples of the
    port's adversarial audio within 1e-6 of JAX's)."""
    jm, pm, wavs, clean = world
    labels = clean if labels is None else labels
    kw = {**ATTACK[kind], "task": "CSI", "targeted": targeted, **kw}
    kw["max_iter"] = kw.get("max_iter", 10)
    want_adv, want = JaxPGD(jm, **kw).attack(
        jnp.asarray(wavs), jnp.asarray(labels), rng=key)
    draws = JaxPgdDraws(key, kw["epsilon"], kw["max_iter"],
                        kw.get("EOT_size", 1), kw.get("num_random_init", 0))
    adver, got = PGD(pm, **kw, **draws.hooks()).attack(wavs, labels)
    # the reference does not clip the init point: 2 eps with restarts
    assert float((adver - torch.tensor(wavs)).abs().max()) <= (
        kw["epsilon"] * (2 if kw.get("num_random_init") else 1) + 1e-6)
    share = float(np.mean(np.abs(adver.numpy() - np.asarray(want_adv))
                          <= 1e-6))
    return [bool(s) for s in want], got, draws, share


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_dithered_default_pgd_matches_jax(worlds, kind):
    """PGD-10 as the CLI runs it by default (Entropy, no restart), every
    score dithered with JAX's draws: 10 gradient scores and the final
    one."""
    want, got, draws, _ = _run_both(worlds[kind], kind,
                                    jax.random.PRNGKey(5))
    assert draws.calls == 11
    assert got == want
    assert 0 < sum(got) < len(got)


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_dithered_step_matches_jax_audio(worlds, kind):
    """One dithered sign step: the port's audio is JAX's."""
    *_, share = _run_both(worlds[kind], kind, jax.random.PRNGKey(5),
                          max_iter=1)
    assert share >= 0.995


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_dithered_score_matches_jax(worlds, kind):
    """model.score(rng=draw) with JAX's normal(key, frames.shape) is JAX's
    score(rng=key)."""
    jm, pm, wavs, _ = worlds[kind]
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.score(jnp.asarray(wavs), rng=key))
    with torch.no_grad():
        got = pm.score(torch.tensor(wavs), rng=lambda shape: np.asarray(
            jax.random.normal(key, shape, jnp.float32))).numpy()
    bar = 2e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bar)
    if kind == "iv":  # there the dither moves the scores past the bar
        with torch.no_grad():
            other = pm.score(torch.tensor(wavs),
                             rng=torch.Generator().manual_seed(3)).numpy()
        assert np.abs(other - want).max() > 100 * bar


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_restart_noise_pgd_matches_jax(worlds, kind):
    """Three random restarts (the best whole-batch success rate wins, the
    earliest on ties), each with JAX's init noise and dither."""
    want, got, draws, share = _run_both(worlds[kind], kind,
                                        jax.random.PRNGKey(8), max_iter=3,
                                        num_random_init=3)
    assert draws.calls == 3 * 4
    assert got == want
    assert share >= 0.95


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_targeted_pgd_matches_jax(worlds, kind):
    """Targeted PGD toward the next speaker of each clean decision."""
    clean = worlds[kind][3]
    target = (clean + 1) % len(SPK)
    want, got, *_ = _run_both(worlds[kind], kind, jax.random.PRNGKey(13),
                              targeted=True, labels=target,
                              **TARGETED[kind])
    assert got == want
    assert 0 < sum(got) < len(got)


def test_mfcc_dither_from_a_draw_function():
    """kaldi_mfcc(rng=draw) adds dither x draw(frames.shape): the same
    features as the generator path when the draw hands out the generator's
    numbers; a draw of the wrong shape raises."""
    wavs = torch.tensor(np.random.default_rng(4).uniform(
        -3000, 3000, (2, 8000)).astype(np.float32))
    want = kaldi_mfcc(wavs, IV_PLDA_MFCC, rng=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    shapes = []

    def draw(shape):
        shapes.append(shape)
        return torch.randn(shape, generator=gen)

    got = kaldi_mfcc(wavs, IV_PLDA_MFCC, rng=draw)
    assert torch.equal(got, want)
    assert shapes == [(2, 50, 400)]
    with pytest.raises(ValueError, match="dither draw"):
        kaldi_mfcc(wavs, IV_PLDA_MFCC, rng=lambda shape: np.zeros((2, 3)))
    off = dataclasses.replace(IV_PLDA_MFCC, dither=0.0)
    assert torch.equal(kaldi_mfcc(wavs, off, rng=draw), kaldi_mfcc(wavs, off))


def test_hooks_reject_what_they_cannot_serve(worlds):
    """dither_fn under a defended model with defenses (its frontend has no
    dither) and init noise of the wrong shape both raise."""
    _, pm, wavs, clean = worlds["iv"]
    defense = parser_defense(["QT"], ["512"], [0], "sequential")[0]
    with pytest.raises(ValueError, match="dither_fn"):
        PGD(DefendedModel(pm, defense), dither_fn=lambda *a: None)
    PGD(DefendedModel(pm), dither_fn=lambda *a: None)  # no defense: fine
    atk = PGD(pm, max_iter=1, num_random_init=1,
              init_noise_fn=lambda r, shape: np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="init noise"):
        atk.attack(wavs, clean)
