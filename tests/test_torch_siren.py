"""The port's SirenAttack (attacks/siren.py) against the JAX package's, on
the same weights, waves and particle draws.

iv-PLDA at the sizes of tests/test_torch_tasks.py (C=64, D=72, IV=32,
R=16, 8000-sample waves, dither 0), five enrolled speakers: task CSI
(no threshold) and OSI (the threshold the median of the clean max scores);
the labels are the clean decisions, imposters (-1) included.  The JAX
attack runs jitted, as it always does, with SG_BLACKBOX_FAST=0 (exact) or
1 (``fast=True``: on the CPU the JAX fast gate is off, so the particle
scores are exact, but the exact-verified retirement guard and the exact
re-scoring of the returned audio run).  The port gets JAX's draws through
``draw_fn``, rebuilt from JAX's key schedule: ``fold_in(rng, epoch)`` ->
``split`` -> (init key, epoch key); the epoch key ``split`` -> (velocity
key, loop key); ``fold_in(loop key, it)`` -> ``split(., 3)`` -> (EOT key,
r1 key, r2 key).

Bars: success vectors identical; gbests (the exact loss of the returned
audio on the fast path) within rtol 1e-4; adversarial waves within 1e-5
(no near tie flipped a particle's best on these runs); the epochs run
equal.  The guard's exact forwards are counted: on a toy SV model whose
fast scores read +1 above the exact ones (tests/test_torch_fakebob.py's),
the fast loss crosses 0 on every lane at once and the exact model never
agrees, so the guard runs on every evaluation of the attack, as the JAX
loop's guard does (it re-fires while a rejected lane keeps its fast gbest
below 0).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import SirenAttack as JaxSiren
from speakerguard_tpu.models.iv_plda import random_iv_plda_params

from speakerguard_tpu_torch import bench
from speakerguard_tpu_torch.attacks import SirenAttack
from speakerguard_tpu_torch.attacks.losses import margin_loss
from speakerguard_tpu_torch.convert import from_jax_params

from test_torch_fakebob import DeceptiveFastSV
from test_torch_kenan import one_cpu_thread  # noqa: F401
from test_torch_tasks import _pair, _world

ATTACK = dict(epsilon=0.004, max_epoch=2, max_iter=6, n_particles=5,
              abort_early_iter=3, abort_early_epoch=1)


@pytest.fixture(scope="module")
def iv():
    """{task: (JAX model, port model, waves, labels, attack threshold)}."""
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=32, reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    wavs = np.random.default_rng(7).uniform(-0.25, 0.25, (8, 8000)).astype(
        np.float32)
    worlds = {}
    jm, pm = _pair("iv", params, tparams, enroll, None)
    worlds["CSI"] = (jm, pm, wavs)
    worlds["OSI"] = _world("iv", params, tparams, enroll, wavs)
    out = {}
    for task, (jm, pm, w) in worlds.items():
        labels = np.array(jm.make_decision(jnp.asarray(w))[0])
        thr = None if task == "CSI" else pm.threshold
        out[task] = (jm, pm, w, labels, thr)
    return out


class JaxDraws:
    """draw_fn handing out the JAX attack's uniform draws."""

    def __init__(self, key, x, epsilon):
        x = jnp.asarray(x)
        self.key = key
        self.lower = jnp.clip(-1.0 - x, -epsilon)[:, None, :]
        self.upper = jnp.clip(1.0 - x, None, epsilon)[:, None, :]
        self.kinds = []

    def __call__(self, kind, epoch, it, shape):
        self.kinds.append((kind, epoch, it))
        ikey, ekey = jax.random.split(jax.random.fold_in(self.key, epoch))
        vkey, lkey = jax.random.split(ekey)
        if kind in ("init", "reinit"):
            v = jax.random.uniform(ikey, shape, jnp.float32, self.lower,
                                   self.upper)
        elif kind == "velocity":
            v_upper = jnp.abs(self.upper - self.lower)
            v = jax.random.uniform(vkey, shape, jnp.float32, -v_upper,
                                   v_upper)
        else:
            _, k1, k2 = jax.random.split(jax.random.fold_in(lkey, it), 3)
            v = jax.random.uniform(k1 if kind == "r1" else k2, shape)
        return torch.tensor(np.asarray(v))


def _run_both(world, monkeypatch, fast, **kw):
    jm, pm, wavs, labels, thr = world
    task = "CSI" if thr is None else "OSI"
    args = dict(ATTACK, task=task, threshold=thr, **kw)
    key = jax.random.PRNGKey(3)
    monkeypatch.setenv("SG_BLACKBOX_FAST", "1" if fast else "0")
    jatk = JaxSiren(jm, **args)
    jadv, jsucc = jatk.attack(jnp.asarray(wavs), jnp.asarray(labels),
                              rng=key)
    draws = JaxDraws(key, wavs, args["epsilon"])
    atk = SirenAttack(pm, fast=fast, draw_fn=draws, **args)
    adv, succ = atk.attack(torch.tensor(wavs), torch.tensor(labels))
    return jatk, np.asarray(jadv), jsucc, atk, adv, succ, draws


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("task", ["CSI", "OSI"])
def test_siren_matches_jax(iv, monkeypatch, task, fast):
    jatk, jadv, jsucc, atk, adv, succ, draws = _run_both(
        iv[task], monkeypatch, fast)
    assert succ == jsucc
    assert 0 < sum(succ) < len(succ)
    assert atk.last_executed_epochs == jatk.last_executed_epochs
    np.testing.assert_allclose(adv.numpy(), jadv, rtol=0, atol=1e-5)
    # the exact loss of the returned audio
    _, pm, wavs, labels, thr = iv[task]
    with torch.no_grad():
        loss = margin_loss(pm.score(adv), torch.tensor(labels), task=task,
                           threshold=thr, clip_max=False)
        jloss = margin_loss(pm.score(torch.tensor(jadv)),
                            torch.tensor(labels), task=task, threshold=thr,
                            clip_max=False)
    np.testing.assert_allclose(loss.numpy(), jloss.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert (loss < 0).tolist() == succ
    assert ("init", 0, None) in draws.kinds
    assert atk.last_guard_evals == 0 if not fast else (
        atk.last_guard_evals > 0)
    assert atk.last_particle_evals <= atk.last_executed_epochs * (
        ATTACK["max_iter"] + 1)


def test_siren_abort_off_runs_every_evaluation(iv, monkeypatch):
    """abort_early=False on OSI: the epochs and their evaluations all run
    while a lane is active; success identical to JAX's."""
    jatk, jadv, jsucc, atk, adv, succ, draws = _run_both(
        iv["OSI"], monkeypatch, False, abort_early=False)
    assert succ == jsucc
    np.testing.assert_allclose(adv.numpy(), jadv, rtol=0, atol=1e-5)
    assert atk.last_executed_epochs == jatk.last_executed_epochs
    assert ("reinit", 1, None) in draws.kinds


def test_siren_guard_fires_on_every_evaluation_of_a_deceptive_fast_path():
    model = DeceptiveFastSV()
    x = torch.tensor(np.random.default_rng(17).uniform(
        -0.2, 0.2, (2, 4000)).astype(np.float32))
    with torch.no_grad():
        tau = float(model.score(x)[:, 0].max()) + 0.2
    model.threshold = tau
    y = torch.full((2,), -1)
    kw = dict(threshold=tau, task="SV", epsilon=0.002, max_epoch=2,
              max_iter=4, n_particles=4, abort_early=False)
    _, want = SirenAttack(model, fast=False, **kw).attack(x, y, rng=3)
    atk = SirenAttack(model, fast=True, **kw)
    adver, got = atk.attack(x, y, rng=3)
    assert got == want == [False, False]
    assert atk.last_executed_epochs == 2
    assert atk.last_guard_evals == atk.last_particle_evals == 2 * 5
    with torch.no_grad():
        assert (model.make_decision(adver)[0] == -1).all()


def test_siren_needs_a_threshold_on_sv_and_osi(iv):
    pm = iv["OSI"][1]
    with pytest.raises(RuntimeError, match="threshold"):
        SirenAttack(pm, task="OSI").attack(torch.zeros(1, 8000),
                                           torch.zeros(1))


def test_siren_batch_size_chunks(iv):
    """batch_size chunks the utterances (the generator advancing through
    the chunks); each chunk's success equals an exact re-evaluation."""
    _, pm, wavs, labels, thr = iv["OSI"]
    atk = SirenAttack(pm, task="OSI", threshold=thr, batch_size=3,
                      **ATTACK)
    adv, succ = atk.attack(torch.tensor(wavs), torch.tensor(labels), rng=0)
    assert adv.shape == wavs.shape and len(succ) == len(wavs)
    with torch.no_grad():
        loss = margin_loss(pm.score(adv), torch.tensor(labels), task="OSI",
                           threshold=thr, clip_max=False)
    assert (loss < 0).tolist() == succ
    assert float((adv - torch.tensor(wavs)).abs().max()) <= 0.004 + 1e-6


def test_bench_siren_entry_prints_one_result_line(capsys):
    model = "audionet"
    assert bench.main(["--model", model, "--attack", "siren", "--device",
                       "cpu", "--batch", "2", "--wav-len", "8000",
                       "--siren-epochs", "1", "--siren-iters", "1",
                       "--siren-particles", "2", "--warmup", "0",
                       "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == f"siren1_{model}_utts_per_sec"
    assert rec["unit"] == "utterances/sec" and rec["value"] > 0
    assert rec["batch"] == 2 and rec["executed_epochs"] == 1
    assert 0.0 <= rec["attack_success_rate_pct"] <= 100.0


@pytest.mark.parametrize("argv,batch,wav_len", [
    (["--attack", "siren"], 32, 48000),
    (["--attack", "siren", "--model", "iv_plda"], 16, 48000),
    (["--attack", "kenan_ssa"], 16, 8000),
    (["--attack", "pgd"], 512, 48000)])
def test_bench_defaults_are_the_jax_points(argv, batch, wav_len):
    """bench.py's points: Siren at xv batch 32 and iv batch 16 (10 epochs x
    30 iterations x 25 particles), Kenan ssa at batch 16 x 8000 samples."""
    args = bench.parse_args(argv)
    assert (args.batch, args.wav_len) == (batch, wav_len)
    assert (args.siren_epochs, args.siren_iters, args.siren_particles,
            args.kenan_iters) == (10, 30, 25, 15)
