"""The port's xv-PLDA slice against the JAX package, on the same weights.

Weights are drawn once with numpy through the JAX package's
random_xv_plda_params and carried across with convert.from_jax_params, so
both packages compute from identical float32 numbers.  Sizes follow the
pair fixture of test_parity_torch.py: full TDNN widths, LDA to 150, five
enrolled speakers, 16000-sample waves, dither 0 (the two frameworks draw
different dither noise).  Bars:

- scores and embeddings: rtol 1e-4, atol 2e-3, test_parity_torch.py's bar
  for xv-PLDA scores (O(10) PLDA scores; embeddings are length-normalised
  to norm sqrt(150));
- features: rtol 1e-4, atol 1e-3, as tests/test_torch_iv_plda.py's;
- the exact input gradient: cosine 0.999 and sign agreement 0.99, as
  tests/test_torch_iv_plda.py's (sign() consumes it).

On the fast path SG_FAST=1 and SG_TDNN_BF16_ACT are set by monkeypatch on
the JAX side only, against the matching ``FastPath``.  On the CPU both
packages' frontends and f32 fast blocks compute in float32; the bf16 blocks
run in bf16 on both sides.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import CWinf as JaxCWinf
from speakerguard_tpu.attacks import FGSM as JaxFGSM
from speakerguard_tpu.attacks import PGD as JaxPGD
from speakerguard_tpu.attacks.losses import cross_entropy_loss as jax_ce
from speakerguard_tpu.models.xv_plda import XvPlda as JaxXvPlda
from speakerguard_tpu.models.xv_plda import (
    load_xv_plda_params as jax_load_xv_plda_params,
    process_emb as jax_process_emb, random_xv_plda_params)
from speakerguard_tpu.ops.kaldi_mfcc import XV_PLDA_MFCC as JAX_XV_MFCC

from speakerguard_tpu_torch import bench
from speakerguard_tpu_torch.attacks import CWinf, FGSM, PGD
from speakerguard_tpu_torch.attacks.losses import cross_entropy_loss
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models.base import FastPath
from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                   load_xv_plda_params,
                                                   process_emb)
from speakerguard_tpu_torch.ops.kaldi_mfcc import XV_PLDA_MFCC

from fixtures import write_mean_vec, write_plda_txt, write_transform_txt
from test_torch_tdnn import _reference_state

SCORE_TOL = dict(rtol=1e-4, atol=2e-3)
# port FastPath, the JAX variables that select the same path (None: exact)
CONFIGS = {
    "exact": (None, None),
    "fast_f32": (FastPath(tdnn_bf16_act=False),
                 {"SG_FAST": "1", "SG_TDNN_BF16_ACT": "0"}),
    "fast_bf16": (FastPath(), {"SG_FAST": "1", "SG_TDNN_BF16_ACT": "1"}),
}
SPK = [str(i) for i in range(5)]


@pytest.fixture(scope="module")
def xv():
    rng = np.random.default_rng(1234)
    params = random_xv_plda_params(rng)
    enroll = rng.standard_normal((5, 150)).astype(np.float32)
    jax_model = JaxXvPlda(params, mfcc_config=dataclasses.replace(
        JAX_XV_MFCC, dither=0.0))
    jax_model.set_enrollment(SPK, enroll)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    return jax_model, tparams, enroll


def _port(tparams, enroll, fast=None):
    m = XvPlda(tparams, mfcc_config=dataclasses.replace(XV_PLDA_MFCC,
                                                        dither=0.0),
               fast=fast)
    m.set_enrollment(SPK, enroll)
    return m


def _wavs(seed, b=3, scale=0.25, origin=True):
    w = np.random.default_rng(seed).uniform(-scale, scale, (b, 16000))
    return (w * (32768 if origin else 1)).astype(np.float32)


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _sign_agreement(got, want):
    nz = np.abs(want) > np.abs(want).max() * 1e-3
    return float(np.mean(np.sign(got[nz]) == np.sign(want[nz])))


@pytest.mark.parametrize("flag", [1, 2])
def test_compute_feat_matches_jax(xv, flag):
    jax_model, tparams, enroll = xv
    wavs = _wavs(5)
    want = np.asarray(jax_model.compute_feat(jnp.asarray(wavs), flag=flag))
    got = _port(tparams, enroll).compute_feat(torch.tensor(wavs),
                                              flag=flag).numpy()
    assert got.shape == want.shape == (3, 100, 30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_process_emb_matches_jax(xv):
    """mean-sub -> LDA -> length-norm -> PLDA transform on the same x-vectors
    (fc1 outputs are O(1)); the result has norm ~sqrt(150)."""
    jax_model, tparams, _ = xv
    emb = np.random.default_rng(13).standard_normal((4, 512)).astype(
        np.float32)
    want = np.asarray(jax_process_emb(jax_model.params, jnp.asarray(emb)))
    got = process_emb(tparams, torch.tensor(emb)).numpy()
    assert got.shape == want.shape == (4, 150)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


@pytest.mark.parametrize("flag", [0, 1, 2])
def test_embedding_and_score_match_jax(xv, flag):
    jax_model, tparams, enroll = xv
    wavs = _wavs(7, b=4)
    x = (wavs if flag == 0 else
         np.asarray(jax_model.compute_feat(jnp.asarray(wavs), flag=flag)))
    want_emb = np.asarray(jax_model.embedding(jnp.asarray(x), flag=flag))
    want = np.asarray(jax_model.score(jnp.asarray(x), flag=flag))
    port = _port(tparams, enroll)
    with torch.no_grad():
        got_emb = port.embedding(torch.tensor(x), flag=flag).numpy()
        got = port.score(torch.tensor(x), flag=flag).numpy()
    assert got.shape == want.shape == (4, 5)
    np.testing.assert_allclose(got_emb, want_emb, **SCORE_TOL)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_make_decision_matches_jax(xv):
    jax_model, tparams, enroll = xv
    wavs = _wavs(29, b=5)
    want_dec, want = jax_model.make_decision(jnp.asarray(wavs))
    with torch.no_grad():
        got_dec, got = _port(tparams, enroll).make_decision(
            torch.tensor(wavs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    assert got_dec.tolist() == np.asarray(want_dec).tolist()


def test_ce_input_gradient_matches_jax(xv):
    """The Entropy loss's waveform gradient on the exact path."""
    jax_model, tparams, enroll = xv
    wavs = _wavs(41, b=4)
    labels = np.array([0, 1, 2, 3])

    def jloss(x):
        return jnp.sum(jax_ce(jax_model.score(x), jnp.asarray(labels)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(wavs)))
    x = torch.tensor(wavs, requires_grad=True)
    cross_entropy_loss(_port(tparams, enroll).score(x),
                       torch.tensor(labels)).sum().backward()
    got = x.grad.numpy()
    assert _cos(got, want) >= 0.999
    assert _sign_agreement(got, want) >= 0.99


def test_fast_none_is_off_on_cpu(xv):
    """fast=None is JAX's SG_FAST=auto: off on the CPU, so fast=True scores
    exactly like the exact path; the model has no fast context."""
    _, tparams, enroll = xv
    port = _port(tparams, enroll)
    assert port.fast_path is None
    x = torch.tensor(_wavs(3, b=2))
    assert port.fast_context(x) is None
    with torch.no_grad():
        np.testing.assert_array_equal(port.score(x).numpy(),
                                      port.score(x, fast=True).numpy())
    assert _port(tparams, enroll, FastPath(enabled=False)).fast_path is None
    assert _port(tparams, enroll, FastPath()).fast_path == FastPath()


@pytest.mark.parametrize("config", ["fast_f32", "fast_bf16"])
def test_fast_scores_and_grads_match_jax(xv, monkeypatch, config):
    """Fast scores and waveform gradients against JAX's fast path.  The f32
    blocks compute the exact forward and an f32 backward on the CPU: the
    exact path's bars.  The bf16 blocks round the same sums to bf16 in five
    layers, and another sum order flips a few of those roundings, which the
    following layers carry on: scores at 2e-3 of their spread (the iv fast
    path's bar; measured 8e-5), the gradient at cosine 0.998 and sign
    agreement 0.98 (measured 0.9989 and 0.9885)."""
    jax_model, tparams, enroll = xv
    fast, env = CONFIGS[config]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    wavs = _wavs(7, b=4)
    x = jnp.asarray(wavs)
    want = np.asarray(jax_model.score(x, fast=True))
    g_want = np.asarray(jax.grad(
        lambda xx: jnp.sum(jax_model.score(xx, fast=True)[:, 0]))(x))
    xt = torch.tensor(wavs, requires_grad=True)
    got = _port(tparams, enroll, fast).score(xt, fast=True)
    got[:, 0].sum().backward()
    got, g = got.detach().numpy(), xt.grad.numpy()
    if config == "fast_f32":
        np.testing.assert_allclose(got, want, **SCORE_TOL)
        assert _cos(g, g_want) >= 0.999
        assert _sign_agreement(g, g_want) >= 0.99
    else:
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
        assert _cos(g, g_want) >= 0.998
        assert _sign_agreement(g, g_want) >= 0.98


def _attack_inputs():
    """Six waves of rising amplitude labelled with the model's own
    decision: CMVN makes the features scale-free, so an epsilon ball is
    larger for the quieter waves and the success vectors are mixed."""
    rng = np.random.default_rng(11)
    scale = np.array([0.02, 0.05, 0.1, 0.15, 0.2, 0.3])[:, None]
    return (rng.uniform(-1, 1, (6, 16000)) * scale).astype(np.float32)


ATTACKS = {  # port class, JAX class, hyperparameters
    "PGD": (PGD, JaxPGD, dict(epsilon=0.004, step_size=0.001, max_iter=5)),
    "FGSM": (FGSM, JaxFGSM, dict(epsilon=0.004)),
    "CWinf": (CWinf, JaxCWinf, dict(epsilon=0.008, step_size=0.002,
                                    max_iter=3)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_attack_success_identical_to_jax(xv, monkeypatch, attack, config):
    """PGD, FGSM and CWinf (untargeted CSI) with the fast iterations of the
    configuration and the exact final evaluation: the success vector equals
    JAX's, the output stays in the epsilon ball, and the returned success
    is what the exact model decides on it.  PGD's and CWinf's vectors are
    mixed; one FGSM step succeeds on none of these waves."""
    jax_model, tparams, enroll = xv
    fast, env = CONFIGS[config]
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    cls, jax_cls, kw = ATTACKS[attack]
    wavs = _attack_inputs()
    port = _port(tparams, enroll, fast)
    with torch.no_grad():
        labels = port.make_decision(torch.tensor(wavs))[0].numpy()
    _, want = jax_cls(jax_model, task="CSI", **kw).attack(
        jnp.asarray(wavs), jnp.asarray(labels))
    adver, got = cls(port, task="CSI", **kw).attack(wavs, labels)
    assert got == [bool(s) for s in want]
    eps = kw["epsilon"]
    assert float((adver - torch.tensor(wavs)).abs().max()) <= eps + 1e-6
    with torch.no_grad():
        dec, _ = port.make_decision(adver)
    assert [int(d) != int(y) for d, y in zip(dec, labels)] == got
    if attack != "FGSM":
        assert 0 < sum(got) < len(got)


@pytest.fixture(scope="module")
def kaldi_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("xv")
    rng = np.random.default_rng(31)
    r = 20
    q, _ = np.linalg.qr(rng.standard_normal((r, r)))
    write_plda_txt(d / "plda.txt", rng.standard_normal(r) * 0.1, q,
                   np.abs(rng.standard_normal(r)) + 0.5)
    write_mean_vec(d / "mean.vec", rng.standard_normal(512) * 0.1)
    write_transform_txt(d / "transform.txt",
                        rng.standard_normal((r, 513)) * 0.05)
    state = _reference_state(rng)
    ckpt = d / "extractor.pt"
    torch.save({k: torch.tensor(v) for k, v in state.items()}, ckpt)
    return state, ckpt, [str(d / n) for n in ("plda.txt", "mean.vec",
                                              "transform.txt")]


@pytest.mark.parametrize("source", ["dict", "path"])
def test_load_xv_plda_params_matches_jax(kaldi_files, source):
    """load_xv_plda_params from a state dict or a checkpoint path plus the
    Kaldi text files: the JAX loader's parameters, as convert.py carries
    them, and the same scores."""
    state, ckpt, files = kaldi_files
    ext = state if source == "dict" else str(ckpt)
    jp = jax_load_xv_plda_params(ext, *files)
    tp = load_xv_plda_params(ext, *files, device="cpu")
    carried = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(carried)):
        assert torch.equal(a, b)
    enroll = np.random.default_rng(2).standard_normal((5, 20)).astype(
        np.float32)
    jax_model = JaxXvPlda(jp, mfcc_config=dataclasses.replace(
        JAX_XV_MFCC, dither=0.0))
    jax_model.set_enrollment(SPK, enroll)
    wavs = _wavs(37, b=2)
    with torch.no_grad():
        got = _port(tp, enroll).score(torch.tensor(wavs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_model.score(
        jnp.asarray(wavs))), **SCORE_TOL)


def test_bench_entry_prints_one_result_line(capsys):
    """python -m speakerguard_tpu_torch.bench on the CPU at a tiny size:
    one JSON line in bench.py's shape."""
    assert bench.main(["--device", "cpu", "--batch", "2", "--wav-len",
                       "8000", "--iters", "2", "--warmup", "0", "--reps",
                       "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "pgd2_xv_plda_utts_per_sec"
    assert rec["unit"] == "utterances/sec" and rec["value"] > 0
    assert rec["batch"] == 2 and rec["device"] == "cpu"
    assert rec["fast_path"] is None
    assert 0.0 <= rec["attack_success_rate_pct"] <= 100.0
