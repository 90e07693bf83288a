"""SV and OSI task semantics of the port against the JAX package, mirroring
tests/test_tasks.py:39-77,91-108 on the real models: the reject threshold
of make_decision, CWinf denial of service and authentication bypass on SV,
and PGD with the Margin loss on OSI.

iv-PLDA at the sizes of tests/test_torch_iv_plda.py (C=64, D=72, IV=32,
R=16, 8000-sample waves) and xv-PLDA at the full TDNN widths of
tests/test_torch_xv_plda.py (16000-sample waves), dither 0 (the two
frameworks draw different dither noise).  SV enrolls one speaker; OSI five.
Each threshold is the median of the clean scores (the largest score for
OSI), so that about half the waves are accepted.  Bars: scores at the
score tolerance of each model's tests; success vectors and the decisions
on the adversarial waves identical to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import CWinf as JaxCWinf
from speakerguard_tpu.attacks import PGD as JaxPGD
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import random_iv_plda_params
from speakerguard_tpu.models.xv_plda import XvPlda as JaxXvPlda
from speakerguard_tpu.models.xv_plda import random_xv_plda_params
from speakerguard_tpu.ops.kaldi_mfcc import IV_PLDA_MFCC as JAX_IV_MFCC
from speakerguard_tpu.ops.kaldi_mfcc import XV_PLDA_MFCC as JAX_XV_MFCC

from speakerguard_tpu_torch.attacks import CWinf, PGD
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models.iv_plda import IvPlda
from speakerguard_tpu_torch.models.xv_plda import XvPlda
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC, XV_PLDA_MFCC

from test_torch_xv_plda import _attack_inputs

SCORE_TOL = {"iv": dict(rtol=1e-3, atol=5e-3),
             "xv": dict(rtol=1e-4, atol=2e-3)}
# small enough that some accepted iv waves stay accepted
IV_ATTACK = dict(epsilon=0.0005, step_size=0.000125, max_iter=5)


def _pair(kind, params, tparams, enroll, threshold):
    spk = [str(i) for i in range(len(enroll))]
    if kind == "iv":
        jax_cls, cls, jmfcc, mfcc = (JaxIvPlda, IvPlda, JAX_IV_MFCC,
                                     IV_PLDA_MFCC)
    else:
        jax_cls, cls, jmfcc, mfcc = (JaxXvPlda, XvPlda, JAX_XV_MFCC,
                                     XV_PLDA_MFCC)
    jm = jax_cls(params, threshold=threshold,
                 mfcc_config=dataclasses.replace(jmfcc, dither=0.0))
    jm.set_enrollment(spk, enroll)
    pm = cls(tparams, threshold=threshold,
             mfcc_config=dataclasses.replace(mfcc, dither=0.0))
    pm.set_enrollment(spk, enroll)
    return jm, pm


def _world(kind, params, tparams, enroll, wavs):
    """(JAX model, port model, waves) with the median threshold."""
    jm, _ = _pair(kind, params, tparams, enroll, None)
    clean = np.asarray(jm.score(jnp.asarray(wavs))).max(axis=1)
    thr = float(np.median(clean))
    return (*_pair(kind, params, tparams, enroll, thr), wavs)


@pytest.fixture(scope="module")
def iv():
    rng = np.random.default_rng(99)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=32, reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    wavs = np.random.default_rng(7).uniform(-0.25, 0.25, (8, 8000)).astype(
        np.float32)
    return {"SV": _world("iv", params, tparams, enroll[:1], wavs),
            "OSI": _world("iv", params, tparams, enroll, wavs)}


@pytest.fixture(scope="module")
def xv_sv():
    rng = np.random.default_rng(1234)
    params = random_xv_plda_params(rng)
    enroll = rng.standard_normal((1, 150)).astype(np.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    return _world("xv", params, tparams, enroll, _attack_inputs())


def _decisions(jm, pm, wavs):
    jd, js = jm.make_decision(jnp.asarray(wavs))
    with torch.no_grad():
        pd, ps = pm.make_decision(torch.tensor(wavs))
    return np.asarray(jd), np.asarray(js), pd.numpy(), ps.numpy()


@pytest.mark.parametrize("kind", ["iv", "xv"])
def test_sv_reject_semantics_match_jax(iv, xv_sv, kind):
    """SV make_decision: 0 iff the score exceeds the threshold, else -1
    (reject); decisions equal JAX's, scores at the score bar, and both
    decisions occur."""
    jm, pm, wavs = iv["SV"] if kind == "iv" else xv_sv
    jd, js, pd, ps = _decisions(jm, pm, wavs)
    assert ps.shape == js.shape == (len(wavs), 1)
    np.testing.assert_allclose(ps, js, **SCORE_TOL[kind])
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pd, np.where(ps[:, 0] > pm.threshold,
                                               0, -1))
    assert sorted(set(pd.tolist())) == [-1, 0]


def _assert_attack_matches(jax_atk, atk, jm, pm, x, y):
    """Success vectors identical, and so are the decisions on the
    adversarial waves; returns the success vector and those decisions."""
    j_adv, want = jax_atk.attack(jnp.asarray(x), jnp.asarray(y))
    adver, got = atk.attack(x, y)
    assert got == [bool(s) for s in want]
    j_dec = np.asarray(jm.make_decision(j_adv)[0])
    with torch.no_grad():
        dec = pm.make_decision(adver)[0].numpy()
    np.testing.assert_array_equal(dec, j_dec)
    eps = atk.epsilon
    assert float((adver - torch.tensor(x)).abs().max()) <= eps + 1e-6
    return got, dec


def test_cwinf_sv_denial_of_service_matches_jax(iv):
    """Untargeted SV on the accepted waves (label 0): a success is a
    reject."""
    jm, pm, wavs = iv["SV"]
    acc = np.where(_decisions(jm, pm, wavs)[2] == 0)[0]
    y = np.zeros(len(acc), np.int64)
    got, dec = _assert_attack_matches(
        JaxCWinf(jm, task="SV", **IV_ATTACK),
        CWinf(pm, task="SV", **IV_ATTACK), jm, pm, wavs[acc], y)
    assert 0 < sum(got) < len(got)
    assert [d == -1 for d in dec] == got


def test_cwinf_sv_authentication_bypass_matches_jax(iv):
    """Targeted SV on the rejected waves, target label 0 (the enrolled
    speaker): a success is an accept."""
    jm, pm, wavs = iv["SV"]
    rej = np.where(_decisions(jm, pm, wavs)[2] == -1)[0]
    y = np.zeros(len(rej), np.int64)
    got, dec = _assert_attack_matches(
        JaxCWinf(jm, task="SV", targeted=True, **IV_ATTACK),
        CWinf(pm, task="SV", targeted=True, **IV_ATTACK), jm, pm,
        wavs[rej], y)
    assert sum(got) > 0
    assert [d == 0 for d in dec] == got


def test_cwinf_sv_both_directions_on_xv_matches_jax(xv_sv):
    """Untargeted SV with the clean decisions as labels on xv-PLDA: the
    accepted waves are pushed to a reject, the rejected ones to an accept
    (margin_loss flips on (label == 0) == targeted)."""
    jm, pm, wavs = xv_sv
    y = _decisions(jm, pm, wavs)[2].astype(np.int64)
    kw = dict(task="SV", epsilon=0.008, step_size=0.002, max_iter=3)
    got, dec = _assert_attack_matches(JaxCWinf(jm, **kw), CWinf(pm, **kw),
                                      jm, pm, wavs, y)
    assert [d != t for d, t in zip(dec, y)] == got
    assert sum(got) > 0


def test_pgd_osi_margin_matches_jax(iv):
    """PGD with the Margin loss on OSI, the clean decisions as labels, the
    rejected waves (label -1) included: an accepted wave succeeds by a
    reject or another speaker, a rejected one by any accept."""
    jm, pm, wavs = iv["OSI"]
    y = _decisions(jm, pm, wavs)[2].astype(np.int64)
    assert -1 in y and (y >= 0).any()
    kw = dict(task="OSI", loss="Margin", **IV_ATTACK)
    got, dec = _assert_attack_matches(JaxPGD(jm, **kw), PGD(pm, **kw), jm,
                                      pm, wavs, y)
    assert 0 < sum(got) < len(got)
    assert [d != t for d, t in zip(dec, y)] == got
