"""The port's NES gradient estimate (adaptive/nes.py) and FAKEBOB
(attacks/fakebob.py) against the JAX package's, on the same weights and the
same noise.

iv-PLDA at the sizes of tests/test_torch_tasks.py (C=64, D=72, IV=32, R=16,
8000-sample waves, dither 0), task OSI with five speakers and SV with one,
each threshold the median of the clean max scores; the labels are the
clean decisions, imposters (-1) included.  Wherever the JAX side draws NES
noise, the port gets the same draws through ``noise_fn``:
``normal(split(fold_in(key, it))[0], (S // 2, B, L))``.  The JAX attack runs
with SG_BLACKBOX_FAST=0 (exact inner forwards) and jitted, as it always is.

Bars, at the score tolerance of tests/test_torch_tasks.py:

- one NES step: mean, adversarial loss and scores at the score bar, the
  majority-vote decisions identical; the gradient within cosine 0.999 and
  sign agreement 0.99 (measured: cosine 1.0000, sign agreement 0.99994);
- the sample chunking: five budgets equal at rtol 1e-6;
- FAKEBOB on OSI, early stop off and on: success vectors identical, the
  audio within epsilon.  Its hyperparameters (eps 0.004, lr 0.002, sigma
  0.01) break five of the eight waves, both labels among them;
- threshold estimation on SV and OSI: the estimates at the score bar.  A
  single sign of one NES step that flips between the frameworks moves this
  model's score by up to ~0.05, and the estimate is the score after
  several steps, so these runs take sigma 0.01 and 50 samples, where the
  steps' signs agree (the JAX package's default 0.001 leaves a flip every
  few steps on this model).

The fast path: the estimate identical with ``fast`` on and off; a toy SV
model whose fast scores read +1 above the exact ones (the JAX package's
tests/test_fast_path.py:417), against which the exact-verified lane
retirement must hold; and success equal to an exact re-evaluation on the
small iv-PLDA's ``FastPath()``.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import FAKEBOB as JaxFAKEBOB
from speakerguard_tpu.adaptive.eot import eot_no_grad as jax_eot_no_grad
from speakerguard_tpu.adaptive.nes import nes_grad as jax_nes_grad
from speakerguard_tpu.attacks.losses import margin_loss as jax_margin_loss
from speakerguard_tpu.models.iv_plda import random_iv_plda_params

from speakerguard_tpu_torch import bench
from speakerguard_tpu_torch.adaptive.eot import eot_no_grad
from speakerguard_tpu_torch.adaptive.nes import nes_grad, sample_chunks
from speakerguard_tpu_torch.attacks import FAKEBOB
from speakerguard_tpu_torch.attacks import fakebob as fakebob_mod
from speakerguard_tpu_torch.attacks.losses import margin_loss
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models.base import FastPath, SRSModel
from speakerguard_tpu_torch.models.iv_plda import IvPlda
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC

from test_torch_tasks import SCORE_TOL, _world

TOL = SCORE_TOL["iv"]
ATTACK = dict(epsilon=0.004, max_iter=12, samples_per_draw=10,
              samples_per_draw_batch_size=10, max_lr=0.002, sigma=0.01)
ESTIMATE = dict(epsilon=0.005, max_lr=0.001, samples_per_draw=50,
                samples_per_draw_batch_size=50, sigma=0.01)


def jax_noise(key):
    """noise_fn drawing the JAX attack's NES noise of iteration ``it``."""
    def fn(it, shape):
        nkey = jax.random.split(jax.random.fold_in(key, it))[0]
        return torch.tensor(np.asarray(jax.random.normal(nkey, shape)))
    return fn


@pytest.fixture(scope="module")
def iv():
    """{task: (JAX model, port model, waves, labels)} and a maker of port
    models with another FastPath."""
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=32, reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    wavs = np.random.default_rng(7).uniform(-0.25, 0.25, (8, 8000)).astype(
        np.float32)
    worlds = {}
    for task, spk in (("SV", enroll[:1]), ("OSI", enroll)):
        jm, pm, _ = _world("iv", params, tparams, spk, wavs)
        labels = np.array(jm.make_decision(jnp.asarray(wavs))[0])
        worlds[task] = (jm, pm, wavs, labels)

    def port_model(task, fast):
        pm = worlds[task][1]
        model = IvPlda(tparams, threshold=pm.threshold, fast=fast,
                       mfcc_config=dataclasses.replace(IV_PLDA_MFCC,
                                                       dither=0.0))
        model.set_enrollment(pm.spk_ids, pm.enroll_embs)
        return model

    return worlds, port_model


def _loss_fn(task, threshold):
    return lambda s, y: margin_loss(s, y, task=task, threshold=threshold,
                                    clip_max=False)


def test_nes_step_matches_jax(iv):
    """One NES step on the OSI waves at the attack's defaults (10 samples,
    sigma 0.001) against JAX's nes_grad with the same noise."""
    worlds, _ = iv
    jm, pm, wavs, labels = worlds["OSI"]
    thr = pm.threshold
    key = jax.random.PRNGKey(5)
    nkey, ekey = jax.random.split(key)
    jeot = jax_eot_no_grad(
        lambda xx, k: jm.score(xx),
        lambda s, y: jax_margin_loss(s, y, task="OSI", threshold=thr,
                                     clip_max=False), jm.threshold)
    want = jax.jit(lambda x, y: jax_nes_grad(
        jeot, x, y, samples_per_draw=10, sigma=0.001, key=nkey,
        num_classes=5, eot_keys=jax.random.split(ekey, 1)))(
        jnp.asarray(wavs), jnp.asarray(labels))
    want = [np.asarray(w) for w in want]
    noise = torch.tensor(np.asarray(jax.random.normal(nkey, (5, 8, 8000))))
    got = nes_grad(eot_no_grad(lambda xx, g: pm.score(xx),
                               _loss_fn("OSI", thr), pm.threshold),
                   torch.tensor(wavs), torch.tensor(labels), noise,
                   samples_per_draw=10, sigma=0.001, num_classes=5)
    got = [g.numpy() for g in got]
    for i in (0, 2, 3):  # mean loss, adversarial loss and scores
        np.testing.assert_allclose(got[i], want[i], **TOL)
    np.testing.assert_array_equal(got[4], want[4])
    g, w = got[1].ravel(), want[1].ravel()
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.999
    assert np.mean(np.sign(g) == np.sign(w)) >= 0.99


def test_sample_chunking_is_invariant(iv):
    """The port of tests/test_attacks.py:184: nes_grad's five outputs equal
    under the budgets None / 8 / 5 / 3 / 1 of 8 samples; the chunks are
    balanced, and a budget of samples_per_draw does not chunk the
    S + 1 points."""
    assert sample_chunks(9, 8, None) == sample_chunks(9, 8, 8) == [9]
    assert sample_chunks(9, 8, 5) == [5, 4]
    assert sample_chunks(9, 8, 1) == [1] * 9
    assert sample_chunks(51, 50, 50) == [51]
    assert sample_chunks(51, 50, 25) == sample_chunks(51, 50, 17) == [17] * 3
    worlds, _ = iv
    _, pm, wavs, labels = worlds["OSI"]
    fn = eot_no_grad(lambda xx, g: pm.score(xx),
                     _loss_fn("OSI", pm.threshold), pm.threshold)
    noise = torch.randn((4, 8, 8000), generator=torch.Generator().manual_seed(1))
    outs = [nes_grad(fn, torch.tensor(wavs), torch.tensor(labels), noise,
                     samples_per_draw=8, sigma=1e-3, num_classes=5,
                     samples_batch=sb) for sb in (None, 8, 5, 3, 1)]
    for out in outs[1:]:
        for ref, got in zip(outs[0], out):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("stop_early", [False, True], ids=["off", "on"])
def test_fakebob_osi_matches_jax(iv, monkeypatch, stop_early):
    """FAKEBOB on OSI, exact path, 13 NES bodies at most, the plateau decay
    firing: success vectors identical to JAX's.  With early stop checked
    every 2 iterations, lanes retire early and the loop ends before
    max_iter + 1 bodies; without, the failed lanes run it to the end."""
    worlds, _ = iv
    jm, pm, wavs, labels = worlds["OSI"]
    assert -1 in labels and (labels >= 0).any()
    kw = dict(task="OSI", threshold=pm.threshold, stop_early=stop_early,
              stop_early_iter=2, **ATTACK)
    monkeypatch.setenv("SG_BLACKBOX_FAST", "0")
    key = jax.random.PRNGKey(0)
    _, want = JaxFAKEBOB(jm, **kw).attack(jnp.asarray(wavs),
                                          jnp.asarray(labels), rng=key)
    triggers = []
    decay = fakebob_mod.plateau_decay

    def recording(*args):
        out = decay(*args)
        triggers.append(int(out[3].sum()))
        return out

    monkeypatch.setattr(fakebob_mod, "plateau_decay", recording)
    atk = FAKEBOB(pm, fast=False, noise_fn=jax_noise(key), **kw)
    adver, got = atk.attack(wavs, labels)
    assert got == [bool(s) for s in want]
    assert 0 < sum(got) < len(got)
    assert {labels[i] == -1 for i, s in enumerate(got) if s} == {True, False}
    assert sum(triggers) > 0
    assert float((adver - torch.tensor(wavs)).abs().max()) <= 0.004 + 1e-6
    bodies = ATTACK["max_iter"] + 1
    assert atk.last_executed_iters == len(triggers)
    assert (atk.last_executed_iters < bodies) == stop_early


@pytest.mark.parametrize("task", ["SV", "OSI"])
def test_estimate_threshold_matches_jax(iv, task):
    """estimate_threshold on two rejected waves against JAX's, with JAX's
    noise (its default key 1): the mean estimate at the score bar, and
    above the model's threshold (each estimate is a score the model
    accepts)."""
    worlds, _ = iv
    jm, pm, wavs, labels = worlds[task]
    rejected = wavs[labels == -1][:2]
    want = JaxFAKEBOB(jm, task=task, **ESTIMATE).estimate_threshold(
        jnp.asarray(rejected), step=0.1)
    atk = FAKEBOB(pm, task=task, noise_fn=jax_noise(jax.random.PRNGKey(1)),
                  **ESTIMATE)
    got = atk.estimate_threshold(rejected, step=0.1)
    np.testing.assert_allclose(got, want, **TOL)
    assert atk.threshold == got > pm.threshold


def test_estimate_threshold_ignores_fast(iv):
    """The port of tests/test_tasks.py:154 on a FastPath() model: the
    estimate is identical with fast on and off, since estimation always
    scores on the exact path."""
    _, port_model = iv
    model = port_model("OSI", FastPath())
    _, _, wavs, labels = iv[0]["OSI"]
    rejected = wavs[labels == -1][:1]
    est = [FAKEBOB(model, task="OSI", fast=fast, **ESTIMATE)
           .estimate_threshold(rejected, step=0.1) for fast in (False, True)]
    assert est[0] is not None and est[0] == est[1]


class DeceptiveFastSV(SRSModel):
    """tests/test_attacks.py's ToyModel as an SV model (one speaker):
    scores = frame means @ w, a dense gradient and a sharp boundary.  Its
    fast path (on through ``FastPath()``) reads +``shift`` above the exact
    scores."""

    allowed_flags = (0, 1)
    range_type = "scale"
    shift = 1.0

    def __init__(self, threshold=0.0, frame=100, length=4000, seed=0):
        super().__init__()
        w = np.random.default_rng(seed).standard_normal((length // frame, 1))
        self.register_buffer("w", torch.tensor(w, dtype=torch.float32))
        self.frame = frame
        self.threshold = threshold
        self.spk_ids = ["enrolled"]
        self.fast = FastPath()

    def _raw(self, wav, rng=None, fast=False):
        return wav.reshape(wav.shape[0], -1, self.frame)

    def _embedding_from_top(self, feats, fast=False, fast_ctx=None):
        emb = feats.mean(-1)
        if self._fast_on(fast) is not None:
            # c with c @ w == shift
            emb = emb + self.shift * self.w[:, 0] / torch.sum(self.w ** 2)
        return emb

    def _scores_from_emb(self, emb, enroll_embs=None):
        return emb @ self.w


def test_retirement_guard_survives_deceptive_fast():
    """The FAKEBOB half of tests/test_fast_path.py:417: the fast loss
    claims success on every (rejected) clean input at iteration 0.  A lane
    may retire only once the exact model confirms, so the fast run's
    success vector equals the exact run's (the constant shift cancels in
    the antithetic estimate), some lane succeeds, and the reported success
    is the exact model's acceptance of the returned audio."""
    model = DeceptiveFastSV()
    x = torch.tensor(np.random.default_rng(17).uniform(
        -0.2, 0.2, (2, 4000)).astype(np.float32))
    with torch.no_grad():
        s_exact = model.score(x)[:, 0]
        s_fast = model.score(x, fast=True)[:, 0]
    tau = float(s_exact.max()) + 0.2
    model.threshold = tau
    np.testing.assert_allclose((s_fast - s_exact).numpy(), 1.0, atol=1e-5)
    assert bool((tau - s_fast < 0).all()) and bool((tau - s_exact > 0).all())
    y = torch.full((2,), -1)
    kw = dict(threshold=tau, task="SV", epsilon=0.3, max_iter=40,
              max_lr=0.02, samples_per_draw=20,
              samples_per_draw_batch_size=20, stop_early=False)
    _, want = FAKEBOB(model, fast=False, **kw).attack(x, y, rng=3)
    atk = FAKEBOB(model, fast=True, **kw)
    adver, got = atk.attack(x, y, rng=3)
    assert got == want and any(got)
    assert atk.last_guard_evals > 0
    with torch.no_grad():
        dec = model.make_decision(adver)[0]
    assert (dec == 0).tolist() == got
    assert float((adver - x).abs().max()) <= 0.3 + 1e-6


def test_fast_success_is_exact(iv):
    """fast=True on the small iv-PLDA's FastPath(): the NES forwards run
    the fast path, and the success vector equals an exact re-evaluation of
    the margin loss of the returned audio under the attack's threshold."""
    worlds, port_model = iv
    _, pm, wavs, labels = worlds["OSI"]
    model = port_model("OSI", FastPath())
    atk = FAKEBOB(model, task="OSI", threshold=pm.threshold,
                  stop_early=False, **ATTACK)
    adver, got = atk.attack(wavs, labels)
    with torch.no_grad():
        loss = _loss_fn("OSI", pm.threshold)(pm.score(adver),
                                              torch.tensor(labels))
    assert (loss < 0).tolist() == got
    assert any(got)


def test_requires_threshold_on_osi(iv):
    """The port of tests/test_tasks.py:126: no threshold on OSI raises."""
    pm = iv[0]["OSI"][1]
    with pytest.raises(RuntimeError):
        FAKEBOB(pm, task="OSI").attack(torch.zeros((1, 8000)),
                                       torch.tensor([0]))


def test_bench_fakebob_entry_prints_one_result_line(capsys):
    """python -m speakerguard_tpu_torch.bench --attack fakebob on the CPU at
    a tiny size: one JSON line named as bench.py names it, with the NES
    bodies the attack ran."""
    assert bench.main(["--model", "audionet", "--attack", "fakebob",
                       "--device", "cpu", "--batch", "2", "--wav-len",
                       "8000", "--fb-iters", "1", "--fb-samples", "2",
                       "--warmup", "0", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "fakebob1_audionet_utts_per_sec"
    assert rec["unit"] == "utterances/sec" and rec["value"] > 0
    assert rec["batch"] == 2 and rec["device"] == "cpu"
    assert 1 <= rec["executed_iters"] <= 2
    assert rec["ms_per_executed_iter"] >= rec["ms_per_iter"] > 0
    assert 0.0 <= rec["attack_success_rate_pct"] <= 100.0
