"""The port's CW2 (attacks/cw2.py) against the JAX package's CW2, on the
same weights.

iv-PLDA at the sizes of tests/test_torch_iv_plda.py (C=64, D=72, IV=32,
R=16, 8000-sample waves, dither 0: the two frameworks draw different dither
noise), task SV (one enrolled speaker, the threshold the median of the
clean scores) and task CSI (five speakers).  The labels are the clean
decisions.  Bars:

- the Adam update against optax.adam at rtol 1e-6;
- the gradient of the CW2 objective: cosine 0.999 and sign agreement 0.99,
  the iv-PLDA gradient bar of tests/test_torch_iv_plda.py;
- success vectors and binary-search consts identical to JAX's; per-sample
  best L2 within rtol 1e-3 (measured: at most 5e-5 relative, at lr 1e-5,
  whose small steps keep the two trajectories together).

The JAX side records each binary-search step's per-sample outcome through a
wrapper of its inner loop; the consts follow from those outcomes by the
reference's binary search, written out here.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from speakerguard_tpu.attacks import CW2 as JaxCW2
from speakerguard_tpu.attacks.losses import margin_loss as jax_margin_loss
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import random_iv_plda_params
from speakerguard_tpu.ops.kaldi_mfcc import IV_PLDA_MFCC as JAX_IV_MFCC

from speakerguard_tpu_torch import bench
from speakerguard_tpu_torch.attacks import CW2
from speakerguard_tpu_torch.attacks.cw2 import ATANH_CLIP, adam_update
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.models.iv_plda import IvPlda
from speakerguard_tpu_torch.ops.chol import cholesky_rt
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC

from test_torch_kenan import one_cpu_thread  # noqa: F401

L2_RTOL = 1e-3
# the stop_early=False configuration: lr 1e-5 leaves half the SV and CSI
# waves unbroken, so both branches of the binary search run
SEARCH = dict(max_iter=10, binary_search_steps=3, stop_early=False,
              initial_const=0.1, lr=1e-5)


def _pair(params, tparams, enroll, threshold=None, fast=None):
    spk = [str(i) for i in range(len(enroll))]
    jm = JaxIvPlda(params, threshold=threshold,
                   mfcc_config=dataclasses.replace(JAX_IV_MFCC, dither=0.0))
    jm.set_enrollment(spk, enroll)
    pm = IvPlda(tparams, threshold=threshold, fast=fast,
                mfcc_config=dataclasses.replace(IV_PLDA_MFCC, dither=0.0))
    pm.set_enrollment(spk, enroll)
    return jm, pm


@pytest.fixture(scope="module")
def iv():
    """{task: (JAX model, port model, labels)}, the waves, and a maker of
    port models with another FastPath."""
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=32, reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    wavs = np.random.default_rng(7).uniform(-0.25, 0.25, (8, 8000)).astype(
        np.float32)
    clean = np.asarray(_pair(params, tparams, enroll[:1])[0].score(
        jnp.asarray(wavs)))[:, 0]
    thr = float(np.median(clean))
    worlds = {}
    for task, spk, t in (("SV", enroll[:1], thr), ("CSI", enroll, None)):
        jm, pm = _pair(params, tparams, spk, t)
        labels = np.asarray(jm.make_decision(jnp.asarray(wavs))[0])
        worlds[task] = (jm, pm, labels)
    assert sorted(set(worlds["SV"][2].tolist())) == [-1, 0]

    def port_model(task, fast):
        spk, t = (enroll[:1], thr) if task == "SV" else (enroll, None)
        return _pair(params, tparams, spk, t, fast)[1]

    return worlds, wavs, port_model


def _binary_search_consts(step_hits, c0):
    """The reference's binary search over c from each step's per-sample
    outcome (speakerguard_tpu/attacks/cw2.py:213-223)."""
    b = len(step_hits[0])
    const = np.full(b, c0, np.float64)
    lower, upper = np.zeros(b), np.full(b, 1e10)
    for hits in step_hits:
        for j in range(b):
            if hits[j]:
                upper[j] = min(upper[j], const[j])
                if upper[j] < 1e9:
                    const[j] = (lower[j] + upper[j]) / 2
            else:
                lower[j] = max(lower[j], const[j])
                if upper[j] < 1e9:
                    const[j] = (lower[j] + upper[j]) / 2
                else:
                    const[j] *= 10
    return const


def _jax_cw2(jm, wavs, labels, **kw):
    """JAX's CW2: (adversarial waves, success, consts)."""
    atk = JaxCW2(jm, **kw)
    steps, inner = [], atk._inner

    def recording(*args):
        out = inner(*args)
        steps.append(np.asarray(out[1]) != -2)
        return out

    atk._inner = recording
    adver, success = atk.attack(jnp.asarray(wavs), jnp.asarray(labels))
    return (np.asarray(adver), [bool(s) for s in success],
            _binary_search_consts(steps, kw["initial_const"]))


def _l2(adver, wavs):
    return np.sum((np.asarray(adver, np.float64) - wavs) ** 2, axis=-1)


def test_adam_update_matches_optax():
    """Three steps from a non-zero state on fixed gradients: update and
    moments against optax.adam's at rtol 1e-6."""
    rng = np.random.default_rng(0)
    lr = 1e-2
    grads = rng.standard_normal((3, 4, 50)).astype(np.float32)
    grads[1, 0] *= 1e-4   # small and large gradients in one tensor
    grads[2, 1] *= 1e3
    mu0 = rng.standard_normal((4, 50)).astype(np.float32) * 0.1
    nu0 = np.abs(rng.standard_normal((4, 50))).astype(np.float32) * 0.01
    opt = optax.adam(lr)
    state = opt.init(jnp.zeros((4, 50)))
    state = (state[0]._replace(mu=jnp.asarray(mu0), nu=jnp.asarray(nu0)),
             state[1])
    mu, nu = torch.tensor(mu0), torch.tensor(nu0)
    for count, g in enumerate(grads, start=1):
        want, state = opt.update(jnp.asarray(g), state)
        got, mu, nu = adam_update(torch.tensor(g), mu, nu, count, lr)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(mu.numpy(), np.asarray(state[0].mu),
                                   rtol=1e-6)
        np.testing.assert_allclose(nu.numpy(), np.asarray(state[0].nu),
                                   rtol=1e-6)


@pytest.mark.parametrize("task", ["SV", "CSI"])
def test_objective_gradient_matches_jax(iv, task):
    """The gradient of sum(c l1 + l2) with respect to the modifier at 0,
    with per-sample consts, against jax.grad of the JAX inner loop's
    objective (speakerguard_tpu/attacks/cw2.py:111-117)."""
    worlds, wavs, _ = iv
    jm, pm, labels = worlds[task]
    const = np.geomspace(0.01, 10.0, len(wavs)).astype(np.float32)
    thr = jm.threshold if task == "SV" else None
    x = jnp.asarray(wavs)
    x_atanh = jnp.arctanh(x * ATANH_CLIP)

    def objective(modifier):
        input_x = jnp.tanh(modifier + x_atanh)
        l1 = jax_margin_loss(jm.score(input_x), jnp.asarray(labels),
                             task=task, threshold=thr, clip_max=True)
        l2 = jnp.sum(jnp.square(input_x - x), axis=-1)
        return jnp.sum(jnp.asarray(const) * l1 + l2)

    want = np.asarray(jax.jit(jax.grad(objective))(jnp.zeros_like(x)))
    atk = CW2(pm, task=task)
    xt = torch.tensor(wavs)
    m = torch.zeros_like(xt, requires_grad=True)
    total, _ = atk.objective(m, xt, torch.atanh(xt * ATANH_CLIP),
                             torch.tensor(labels), torch.tensor(const))
    (got,) = torch.autograd.grad(total, m)
    got, want = got.numpy().ravel(), want.ravel()
    assert got @ want / (np.linalg.norm(got) * np.linalg.norm(want)) >= 0.999
    assert np.mean(np.sign(got) == np.sign(want)) >= 0.99


@pytest.mark.parametrize("task", ["SV", "CSI"])
def test_success_and_consts_identical_to_jax(iv, task):
    """stop_early=False: the success vector and the consts equal JAX's, the
    best L2 is within L2_RTOL, and each broken wave is what the exact model
    decides on it."""
    worlds, wavs, _ = iv
    jm, pm, labels = worlds[task]
    j_adv, want, j_consts = _jax_cw2(jm, wavs, labels, task=task, **SEARCH)
    atk = CW2(pm, task=task, **SEARCH)
    adver, got = atk.attack(wavs, labels)
    assert got == want
    assert 0 < sum(got) < len(got)
    np.testing.assert_array_equal(atk.consts, j_consts)
    assert len(set(atk.consts.tolist())) > 1
    np.testing.assert_allclose(_l2(adver, wavs), _l2(j_adv, wavs),
                               rtol=L2_RTOL)
    with torch.no_grad():
        dec = pm.make_decision(adver)[0].numpy()
    assert (dec != labels).tolist() == got
    # a failed wave comes back as it went in
    for i, s in enumerate(got):
        if not s:
            assert np.array_equal(adver[i].numpy(), wavs[i])


# tests/test_attacks.py's eager-oracle configuration (max_iter 23, two
# binary-search steps, early-stop checks every 7 iterations) with its lr
# and initial const, and with lr 1e-3 and const 1e-3, under which the SV
# consts part ways and the early stop fires at another iteration
EARLY_STOP = {"oracle": dict(lr=1e-2, initial_const=1e-1),
              "small_c": dict(lr=1e-3, initial_const=1e-3)}


@pytest.mark.parametrize("case", sorted(EARLY_STOP))
@pytest.mark.parametrize("task", ["SV", "CSI"])
def test_early_stop_identical_to_jax(iv, task, case):
    """stop_early=True: the plateau check at iteration 0 against an
    infinite previous loss, the iteration at which it fires, and the
    max_iter + 1-th evaluation, held to JAX through the success vector and
    the consts.  The number of model evaluations (one Cholesky each) shows
    whether the early stop fired."""
    worlds, wavs, _ = iv
    jm, pm, labels = worlds[task]
    kw = dict(task=task, max_iter=23, binary_search_steps=2,
              stop_early=True, stop_early_iter=7, **EARLY_STOP[case])
    _, want, j_consts = _jax_cw2(jm, wavs, labels, **kw)
    atk = CW2(pm, **kw)
    cholesky_rt.reset_counts()
    _, got = atk.attack(wavs, labels)
    assert got == want
    np.testing.assert_array_equal(atk.consts, j_consts)
    evals = cholesky_rt.plain_calls
    if case == "oracle":
        assert evals < 2 * 24   # the plateau check fired in both steps
    if case == "small_c" and task == "SV":
        assert evals < 2 * 24
        assert len(set(atk.consts.tolist())) > 1


def test_fast_success_is_exact(iv):
    """fast=True on a FastPath() model (tests/test_fast_path.py:306-337's
    configuration): every reported success flips the exact model's
    decision, and the success vector equals the exact run's."""
    worlds, wavs, port_model = iv
    _, pm, labels = worlds["SV"]
    kw = dict(task="SV", max_iter=8, binary_search_steps=2,
              stop_early=False, initial_const=10.0)
    _, want = CW2(pm, **kw).attack(wavs, labels)
    adver, got = CW2(port_model("SV", FastPath()), fast=True,
                     **kw).attack(wavs, labels)
    assert got == want
    with torch.no_grad():
        dec = pm.make_decision(adver)[0].numpy()
    for d, y, s in zip(dec, labels, got):
        if s:
            assert d != y


def test_fast_topk_success_is_exact(iv):
    """fast_topk=True (SG_CW2_TOPK=1) with a 32-of-64 top-K selection
    frozen from the clean input: every reported success flips the exact
    model's decision."""
    worlds, wavs, port_model = iv
    _, pm, labels = worlds["SV"]
    fast = port_model("SV", FastPath(gmm_topk=32))
    assert fast.fast_context(torch.tensor(wavs)) is not None
    adver, got = CW2(fast, task="SV", max_iter=8, binary_search_steps=2,
                     stop_early=False, initial_const=10.0, fast=True,
                     fast_topk=True).attack(wavs, labels)
    with torch.no_grad():
        dec = pm.make_decision(adver)[0].numpy()
    assert got == (dec != labels).tolist()
    assert sum(got) > 0


def test_batch_size_chunks_match_one_batch(iv):
    """batch_size=3 over 8 waves: the same success vector and consts as one
    batch."""
    worlds, wavs, _ = iv
    _, pm, labels = worlds["SV"]
    whole = CW2(pm, task="SV", **SEARCH)
    _, want = whole.attack(wavs, labels)
    chunked = CW2(pm, task="SV", batch_size=3, **SEARCH)
    adver, got = chunked.attack(wavs, labels)
    assert got == want
    np.testing.assert_array_equal(chunked.consts, whole.consts)
    assert adver.shape == wavs.shape


def test_bench_cw2_entry_prints_one_result_line(capsys):
    """python -m speakerguard_tpu_torch.bench --model iv_plda --attack cw2
    on the CPU at a tiny size: one JSON line named as bench.py names it."""
    assert bench.main(["--model", "iv_plda", "--attack", "cw2", "--device",
                       "cpu", "--batch", "2", "--wav-len", "8000",
                       "--cw2-iters", "1", "--cw2-bss", "1", "--warmup",
                       "0", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "cw21_iv_plda_utts_per_sec"
    assert rec["unit"] == "utterances/sec" and rec["value"] > 0
    assert rec["batch"] == 2 and rec["device"] == "cpu"
    assert rec["fast_path"] is None
    assert 0.0 <= rec["attack_success_rate_pct"] <= 100.0
