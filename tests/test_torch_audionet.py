"""The port's AudioNet CSI-NE slice against the JAX package, on the same
weights.

Weights come from the JAX package (``init_audionet``, its loader, or the
``TorchAudioNet`` oracle of test_networks.py) and are carried across with
``convert.from_jax_params``, so both packages compute from identical
float32 numbers.  The attack fixture's BatchNorm running stats are the
batch statistics of 8 waves (40 of JAX's train-mode updates): with
init's mean 0 / variance 1 every wave gets the same decision and no attack
at eps 0.002 moves any.  Sizes: at most 6 waves of
at most 16000 samples and at most 6 classes.  Bars:

- features: rtol 1e-4, atol 1e-3 (dB); scores and logits: rtol 1e-4,
  atol 2e-3; the train-mode new state: rtol 1e-5, atol 1e-6;
- the exact waveform gradient: cosine 0.999 and sign agreement 0.99, as
  the iv and xv tests hold it (sign() consumes it);
- FGSM and PGD success vectors, untargeted and targeted, and with
  EOT_size 2: identical to JAX's on the exact path;
- the bf16 CNN (``FastPath.audionet_bf16``, JAX SG_AUDIONET_BF16) on the
  same float32 features: its embedding and its feature gradient equal
  JAX's bit for bit (both packages round every bf16 step alike);
- the bf16 path from the wave, port against JAX, both in bf16 on the CPU:
  scores within 1e-3 of their largest entry, the waveform gradient at
  cosine 0.99 and sign agreement 0.97 (measured on the two cases below:
  scores 7.6e-8 and 1.9e-4 of the largest, cosine 1.0000 and 0.99559,
  sign agreement 1.0 and 0.97793), and the attacks' success vectors
  within one wave of JAX's (measured: equal in three of the four attacks,
  one wave apart in untargeted PGD).  The two float32 frontends differ by
  up to ~1e-4 dB (another order of sums); the cast to bf16 (an ulp of
  0.125 dB at 30 dB) rounds a few features to the other neighbour, and
  one such feature can move a max-pool tie or the max over time to
  another frame, which sends that utterance's gradient through other
  samples (the second case: one of three utterances at cosine 0.986).
  The xv bf16 blocks' 0.998 / 0.98 held on the first case only.  JAX's
  own bar of bf16 against f32 (scores within 0.08 of their spread,
  cosine 0.9) holds for the port's bf16 against its f32 path.

On the fast path SG_FAST=1 and SG_AUDIONET_BF16 are set by monkeypatch on
the JAX side only, against the matching ``FastPath``.  On the CPU both
packages' DFTs are float32 on the fast path too.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.adaptive.eot import eot as jax_eot
from speakerguard_tpu.attacks import FGSM as JaxFGSM
from speakerguard_tpu.attacks import PGD as JaxPGD
from speakerguard_tpu.attacks.losses import cross_entropy_loss as jax_ce
from speakerguard_tpu.attacks.losses import resolve_loss as jax_resolve_loss
from speakerguard_tpu.models import audionet as jax_an
from speakerguard_tpu.ops.logmel import audionet_logmel as jax_logmel

from speakerguard_tpu_torch import bench
from speakerguard_tpu_torch.adaptive.eot import eot
from speakerguard_tpu_torch.attacks import FGSM, PGD
from speakerguard_tpu_torch.attacks.losses import (cross_entropy_loss,
                                                   resolve_loss)
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models import audionet as an
from speakerguard_tpu_torch.models.base import FastPath

from test_networks import TorchAudioNet

FEAT_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_TOL = dict(rtol=1e-4, atol=2e-3)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
# port FastPath, the JAX variables that select the same path (None: exact)
# (the f32 CNN of FastPath(audionet_bf16=False) with its float32 DFT on
# the CPU is the exact path)
CONFIGS = {
    "exact": (None, None),
    "fast_bf16": (FastPath(), {"SG_FAST": "1", "SG_AUDIONET_BF16": "1"}),
}


def _carry(pair):
    return from_jax_params(jax.tree.map(np.asarray, pair), device="cpu")


def _pair(jax_pair, fast=None):
    """(JAX AudioNet, the port's AudioNet) on the same weights."""
    return (jax_an.AudioNet(*jax_pair),
            an.AudioNet(*_carry(jax_pair), fast=fast))


def _wavs(seed, b=3, length=8000, scale=0.4):
    return np.random.default_rng(seed).uniform(
        -scale, scale, (b, length)).astype(np.float32)


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _sign_agreement(got, want):
    nz = np.abs(want) > np.abs(want).max() * 1e-3
    return float(np.mean(np.sign(got[nz]) == np.sign(want[nz])))


def _set_env(monkeypatch, env):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def oracle():
    """test_parity_torch.py's fixture: the TorchAudioNet oracle (6 classes,
    seed 7) through the JAX loader."""
    torch.manual_seed(7)
    net = TorchAudioNet(num_class=6).eval()
    return jax_an.load_audionet_from_torch_state(net.state_dict()), net


@pytest.fixture(scope="module")
def calibrated():
    """init_audionet(seed 7, 4 classes) with running stats set to the batch
    statistics of 8 waves (40 train-mode updates)."""
    params, state = jax_an.init_audionet(np.random.default_rng(7), 4)
    feats = jax_logmel(jnp.asarray(_wavs(8, b=8, scale=0.3)))
    step = jax.jit(lambda s: jax_an.audionet_logits(params, s, feats,
                                                    train=True)[2])
    for _ in range(40):
        state = step(state)
    return params, state


@pytest.mark.parametrize("seed,num_class", [(0, 10), (40, 6)])
def test_init_matches_jax_bit_for_bit(seed, num_class):
    got = an.init_audionet(np.random.default_rng(seed), num_class,
                           device="cpu")
    want = _carry(jax_an.init_audionet(np.random.default_rng(seed),
                                       num_class))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    net, state = got
    assert net.conv1_w.shape == (1, 1, 5, 5)
    assert [tuple(w.shape) for w in net.conv_w] == [
        (cout, cin, k) for cin, cout, k, _, _ in an.CONV_SPEC]
    assert net.fc_w.shape == (32, num_class)
    assert state.conv1_var.shape == (1,) and len(state.vars) == 7


def test_loader_matches_oracle_and_jax(oracle):
    """test_networks.py's oracle case: the state dict read straight into the
    port's tensors equals the JAX loader's weights carried across, and the
    logits match the oracle's own forward."""
    jax_pair, net = oracle
    tp = an.load_audionet_from_torch_state(net.state_dict(), device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(_carry(jax_pair))):
        assert torch.equal(a, b)
    feats = np.random.default_rng(0).standard_normal((2, 50, 32)).astype(
        np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(feats).transpose(1, 2)).numpy()
        got = an.audionet_logits(*tp, torch.tensor(feats))[0].numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)


@pytest.mark.parametrize("t", [50, 20, 9])
def test_logits_match_jax(calibrated, t):
    """Logits and embeddings on features of T frames: after three pools T=20
    leaves 2 frames and T=9 leaves 1, so conv8's repeat-if-too-short tiles
    them (test_networks.py's T=20 case)."""
    feats = np.random.default_rng(t).standard_normal((2, t, 32)).astype(
        np.float32) * 10
    want, want_emb, _ = jax.jit(jax_an.audionet_logits)(
        *calibrated, jnp.asarray(feats))
    got, got_emb, _ = an.audionet_logits(*_carry(calibrated),
                                         torch.tensor(feats))
    assert got.shape == (2, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               **SCORE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


def test_train_mode_new_state_matches_jax():
    """train=True normalises with the batch statistics and moves every
    running mean and variance (unbiased) by momentum 0.1, value for value
    as JAX does; eval mode hands the state back as it is."""
    jax_pair = jax_an.init_audionet(np.random.default_rng(1), 5)
    feats = np.random.default_rng(2).standard_normal((4, 50, 32)).astype(
        np.float32)
    want, _, want_state = jax.jit(jax_an.audionet_logits,
                                  static_argnames="train")(
        *jax_pair, jnp.asarray(feats), train=True)
    params, state = _carry(jax_pair)
    got, _, new_state = an.audionet_logits(params, state,
                                           torch.tensor(feats), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    for a, b in zip(jax.tree.leaves(new_state), jax.tree.leaves(want_state)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STATE_TOL)
    assert not torch.equal(new_state.means[0], state.means[0])
    _, _, same = an.audionet_logits(params, state, torch.tensor(feats))
    assert all(a is b for a, b in zip(jax.tree.leaves(same),
                                      jax.tree.leaves(state)))


def test_compute_feat_matches_jax(oracle):
    jax_model, port = _pair(oracle[0])
    wavs = _wavs(5)
    want = np.asarray(jax_model.compute_feat(jnp.asarray(wavs), flag=1))
    got = port.compute_feat(torch.tensor(wavs), flag=1).numpy()
    assert got.shape == want.shape == (3, 50, 32)
    np.testing.assert_allclose(got, want, **FEAT_TOL)
    with pytest.raises(ValueError, match="no feature ladder"):
        port._feat_step(torch.tensor(got), 1)


@pytest.mark.parametrize("flag", [0, 1])
def test_scores_and_decisions_match_jax(oracle, flag):
    """test_parity_torch.py's score case (3 waves of 8000 samples, seed
    31), from the wave and from the log-mel feature."""
    jax_model, port = _pair(oracle[0])
    wavs = _wavs(31)
    x = (wavs if flag == 0 else
         np.asarray(jax_model.compute_feat(jnp.asarray(wavs), flag=1)))
    want_dec, want = jax.jit(lambda xx: jax_model.make_decision(
        xx, flag=flag))(jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = port.score(torch.tensor(x), flag=flag).numpy()
        got_dec, _ = port.make_decision(torch.tensor(x), flag=flag)
        emb = port.embedding(torch.tensor(x), flag=flag)
        alias = port.predict_from_embeddings(emb).numpy()
    assert got.shape == want.shape == (3, 6)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    np.testing.assert_array_equal(alias, got)
    assert got_dec.tolist() == np.asarray(want_dec).tolist()
    assert port.num_spks == 6 and port.threshold == float("-inf")


def test_ce_input_gradient_matches_jax(calibrated):
    """The Entropy loss's waveform gradient on the exact path."""
    jax_model, port = _pair(calibrated)
    wavs = _wavs(41, b=4)
    labels = np.array([0, 1, 2, 3])
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jax_ce(
        jax_model.score(x), jnp.asarray(labels)))))(jnp.asarray(wavs)))
    x = torch.tensor(wavs, requires_grad=True)
    cross_entropy_loss(port.score(x), torch.tensor(labels)).sum().backward()
    assert _cos(x.grad.numpy(), want) >= 0.999
    assert _sign_agreement(x.grad.numpy(), want) >= 0.99


def test_fgsm_parity_on_oracle_weights(oracle):
    """test_parity_torch.py's BASELINE config 1 case: FGSM (eps 0.002,
    Entropy) on 6 waves with random labels; identical per-sample success."""
    jax_model, port = _pair(oracle[0])
    rng = np.random.default_rng(37)
    wavs = rng.uniform(-0.4, 0.4, (6, 8000)).astype(np.float32)
    labels = rng.integers(0, 6, 6)
    _, want = JaxFGSM(jax_model, task="CSI", epsilon=0.002,
                      loss="Entropy").attack(jnp.asarray(wavs),
                                             jnp.asarray(labels))
    adver, got = FGSM(port, task="CSI", epsilon=0.002,
                      loss="Entropy").attack(wavs, labels)
    assert got == [bool(s) for s in want]
    assert float((adver - torch.tensor(wavs)).abs().max()) <= 0.002 + 1e-6


@pytest.mark.parametrize("eot_size", [1, 2])
def test_eot_gradient_equals_plain_grad(calibrated, eot_size):
    """test_attacks.py's EOT case: EOT of size 1 is the plain gradient, and
    AudioNet draws nothing, so size 2 averages two equal gradients into the
    same one, bit for bit; both agree with JAX's EOT gradient."""
    jax_model, port = _pair(calibrated)
    wavs = _wavs(3, b=2, length=4000, scale=0.3)
    with torch.no_grad():
        y = port.make_decision(torch.tensor(wavs))[0].long()
    loss_fn, _ = resolve_loss("Entropy", task="CSI")
    run = eot(lambda xx, g: port.score(xx, rng=g), loss_fn, port.threshold,
              eot_size)
    x = torch.tensor(wavs)
    _, _, grad, dec = run(x, y, None)
    assert dec.shape == (eot_size, 2)
    xx = x.clone().requires_grad_(True)
    loss_fn(port.score(xx), y).sum().backward()
    assert torch.equal(grad, xx.grad)
    jloss, _ = jax_resolve_loss("Entropy", task="CSI")
    jrun = jax_eot(lambda xx, k: jax_model.score(xx), jloss,
                   jax_model.threshold, eot_size)
    keys = jax.random.split(jax.random.PRNGKey(0), eot_size)
    want = np.asarray(jax.jit(lambda x, yy: jrun(x, yy, keys)[2])(
        jnp.asarray(wavs), jnp.asarray(y.numpy())))
    assert _cos(grad.numpy(), want) >= 0.999
    assert _sign_agreement(grad.numpy(), want) >= 0.99


def _attack_inputs():
    """Six waves of rising amplitude: the quieter the wave, the larger an
    epsilon ball is against it, so the success vectors are mixed."""
    rng = np.random.default_rng(11)
    scale = np.array([0.05, 0.1, 0.2, 0.4, 0.6, 0.9])[:, None]
    return (rng.uniform(-1, 1, (6, 8000)) * scale).astype(np.float32)


ATTACKS = {  # port class, JAX class, hyperparameters
    "PGD": (PGD, JaxPGD, dict(epsilon=0.002, step_size=0.0004, max_iter=5)),
    "FGSM": (FGSM, JaxFGSM, dict(epsilon=0.002)),
}


def _labels(port, wavs, targeted):
    """The exact decisions, or as targets each wave's second-best class."""
    with torch.no_grad():
        scores = port.score(torch.tensor(wavs))
    return (scores.argsort(dim=1)[:, -2] if targeted
            else scores.argmax(dim=1)).numpy()


def _run_attack_pair(calibrated, monkeypatch, attack, config, targeted):
    """The attack on both packages with the configuration's fast path:
    (labels, JAX's success vector, the port's adversarial waves, its
    success vector, the port's model)."""
    fast, env = CONFIGS[config]
    _set_env(monkeypatch, env)
    jax_model, port = _pair(calibrated, fast)
    cls, jax_cls, kw = ATTACKS[attack]
    wavs = _attack_inputs()
    y = _labels(port, wavs, targeted)
    _, want = jax_cls(jax_model, task="CSI", targeted=targeted,
                      **kw).attack(jnp.asarray(wavs), jnp.asarray(y))
    adver, got = cls(port, task="CSI", targeted=targeted, **kw).attack(
        wavs, y)
    assert float((adver - torch.tensor(wavs)).abs().max()) <= 0.002 + 1e-6
    with torch.no_grad():
        dec, _ = port.make_decision(adver)
    assert [(int(d) == t) == targeted for d, t in zip(dec, y)] == got
    return [bool(s) for s in want], got


@pytest.mark.parametrize("targeted", [False, True],
                         ids=["untargeted", "targeted"])
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_attack_success_identical_to_jax(calibrated, monkeypatch, attack,
                                         targeted):
    """PGD and FGSM (CSI, untargeted or toward the second-best class) on
    the exact path: the success vector equals JAX's, the output stays in
    the epsilon ball, and the returned success is what the exact model
    decides on it.  Every vector is mixed."""
    want, got = _run_attack_pair(calibrated, monkeypatch, attack, "exact",
                                 targeted)
    assert got == want
    assert 0 < sum(got) < len(got)


@pytest.mark.parametrize("targeted", [False, True],
                         ids=["untargeted", "targeted"])
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_bf16_attack_success_tracks_jax(calibrated, monkeypatch, attack,
                                        targeted):
    """The same attacks through the bf16 CNN: in the ball, exact-verified
    success, and within one wave of JAX's success vector (see the module
    docstring for why the bf16 path is not held to equality)."""
    want, got = _run_attack_pair(calibrated, monkeypatch, attack,
                                 "fast_bf16", targeted)
    assert sum(a != b for a, b in zip(got, want)) <= 1


def test_pgd_eot2_equals_eot1_and_jax(calibrated):
    """PGD with EOT_size=2 takes the same steps as EOT_size=1 (AudioNet
    draws nothing), so the adversarial waves are equal; the success vector
    equals JAX's EOT_size=2 run."""
    jax_model, port = _pair(calibrated)
    wavs = _attack_inputs()
    y = _labels(port, wavs, False)
    kw = ATTACKS["PGD"][2]
    adv1, s1 = PGD(port, task="CSI", **kw).attack(wavs, y)
    adv2, s2 = PGD(port, task="CSI", EOT_size=2, **kw).attack(wavs, y)
    assert torch.equal(adv1, adv2) and s1 == s2
    _, want = JaxPGD(jax_model, task="CSI", EOT_size=2, **kw).attack(
        jnp.asarray(wavs), jnp.asarray(y))
    assert s2 == [bool(s) for s in want]


def test_pgd_on_small_audionet_matches_jax():
    """test_attacks.py's AudioNet smoke case (4 classes, 2 waves of 4000
    samples, eps 0.02, 3 iterations): in the ball, JAX's success vector."""
    jax_model, port = _pair(jax_an.init_audionet(np.random.default_rng(7),
                                                 4))
    wavs = _wavs(3, b=2, length=4000, scale=0.3)
    with torch.no_grad():
        y = port.make_decision(torch.tensor(wavs))[0].numpy()
    kw = dict(task="CSI", epsilon=0.02, step_size=0.004, max_iter=3)
    _, want = JaxPGD(jax_model, **kw).attack(jnp.asarray(wavs),
                                             jnp.asarray(y))
    adver, got = PGD(port, **kw).attack(wavs, y)
    assert adver.shape == (2, 4000)
    assert float((adver - torch.tensor(wavs)).abs().max()) <= 0.02 + 1e-5
    assert got == [bool(s) for s in want]


def _fast_score_and_grad(model, wavs, is_jax=False):
    """Scores and the gradient of the first two scores' sum, fast path."""
    if is_jax:
        def f(xx):
            scores = model.score(xx, fast=True)
            return jnp.sum(scores[:, :2]), scores
        (_, scores), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(wavs))
        return np.asarray(scores), np.asarray(g)
    x = torch.tensor(wavs, requires_grad=True)
    s = model.score(x, fast=True)
    s[:, :2].sum().backward()
    return s.detach().numpy(), x.grad.numpy()


def test_bf16_cnn_equals_jax_on_same_features(calibrated):
    """The bf16 CNN alone, on the same float32 features, as the fast path
    calls it (weights, running stats and features cast to bf16, the
    embedding back to float32, the fc head float32): the embedding and the
    gradient of the Entropy loss with respect to the features are JAX's,
    bit for bit."""
    params, state = calibrated
    feats = np.asarray(jax_logmel(jnp.asarray(_attack_inputs())))
    y = np.array([0, 1, 2, 3, 0, 1])

    def jax_loss(f):
        p16, s16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                (params, state))
        emb, _ = jax_an.audionet_embedding(p16, s16, f.astype(jnp.bfloat16))
        emb = emb.astype(jnp.float32)
        return jnp.sum(jax_ce(emb @ params.fc_w + params.fc_b,
                              jnp.asarray(y))), emb

    (_, want), g_want = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(feats))
    port = an.AudioNet(*_carry(calibrated), fast=FastPath())
    f = torch.tensor(feats, requires_grad=True)
    emb = port.embedding(f, flag=1, fast=True)
    cross_entropy_loss(port.predict_from_embeddings(emb),
                       torch.tensor(y)).sum().backward()
    assert emb.dtype == torch.float32
    np.testing.assert_array_equal(emb.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(g_want))


@pytest.mark.parametrize("case", [(40, 41, 8000), (3, 103, 16000)],
                         ids=["seed40", "seed3"])
def test_bf16_scores_and_grads_match_jax(monkeypatch, case):
    """The bf16 CNN against JAX's on the CPU (init seed, wave seed, length;
    the first is test_fast_path.py's case)."""
    init_seed, wav_seed, length = case
    _set_env(monkeypatch, CONFIGS["fast_bf16"][1])
    jax_model, port = _pair(jax_an.init_audionet(
        np.random.default_rng(init_seed), 6), FastPath())
    wavs = _wavs(wav_seed, length=length)
    want, g_want = _fast_score_and_grad(jax_model, wavs, is_jax=True)
    got, g = _fast_score_and_grad(port, wavs)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert _cos(g, g_want) >= 0.99
    assert _sign_agreement(g, g_want) >= 0.97


def test_bf16_against_f32_within_jax_bar_and_pgd():
    """test_fast_path.py's SG_AUDIONET_BF16 case on the port alone: the bf16
    CNN's scores and gradient against the f32 CNN's at JAX's own bar, and
    PGD through it stays in the ball with exact-verified success."""
    pair = _carry(jax_an.init_audionet(np.random.default_rng(40), 6))
    wavs = _wavs(41)
    s_base, g_base = _fast_score_and_grad(
        an.AudioNet(*pair, fast=FastPath(audionet_bf16=False)), wavs)
    bf16 = an.AudioNet(*pair, fast=FastPath())
    s_bf16, g_bf16 = _fast_score_and_grad(bf16, wavs)
    assert np.abs(s_bf16 - s_base).max() < 0.08 * max(
        np.abs(s_base).max(), 1.0)
    assert _cos(g_base, g_bf16) > 0.9
    with torch.no_grad():
        y = bf16.make_decision(torch.tensor(wavs))[0].numpy()
    adver, success = PGD(bf16, task="CSI", epsilon=0.005, step_size=0.001,
                         max_iter=3).attack(wavs, y)
    assert float((adver - torch.tensor(wavs)).abs().max()) <= 0.005 + 1e-6
    with torch.no_grad():
        dec, _ = bf16.make_decision(adver)
    assert [int(d) != int(t) for d, t in zip(dec, y)] == success


def test_fast_dft_knob_leaves_exact_path(monkeypatch):
    """test_fast_path.py's DFT-knob case: dft_bf16 changes only the fast
    path; the exact scores are bit-equal, the fast ones close (equal on the
    CPU, where the fast DFT is float32 as JAX's DEFAULT is)."""
    pair = _carry(jax_an.init_audionet(np.random.default_rng(20), 6))
    x = torch.tensor(_wavs(21, b=2, scale=0.4))
    base = an.AudioNet(*pair, fast=FastPath(dft_bf16=False))
    knob = an.AudioNet(*pair, fast=FastPath(dft_bf16=True))
    with torch.no_grad():
        np.testing.assert_array_equal(knob.score(x).numpy(),
                                      base.score(x).numpy())
        np.testing.assert_allclose(knob.score(x, fast=True).numpy(),
                                   base.score(x, fast=True).numpy(),
                                   rtol=1e-3, atol=1e-3)


def test_fast_none_is_off_on_cpu(calibrated):
    """fast=None is JAX's SG_FAST=auto: off on the CPU, so fast=True scores
    exactly like the exact path; the model has no fast context."""
    pair = _carry(calibrated)
    port = an.AudioNet(*pair)
    assert port.fast_path is None
    x = torch.tensor(_wavs(3, b=2))
    assert port.fast_context(x) is None
    with torch.no_grad():
        np.testing.assert_array_equal(port.score(x).numpy(),
                                      port.score(x, fast=True).numpy())
    assert an.AudioNet(*pair, fast=FastPath()).fast_path == FastPath()


def test_parse_label_encoder_matches_jax(tmp_path):
    path = tmp_path / "label_encoder.txt"
    path.write_text("'spk_b' 1\n'spk_a' 0\n'spk_c' 2\n")
    assert an.parse_label_encoder(str(path)) == \
        jax_an.parse_label_encoder(str(path)) == ["spk_a", "spk_b", "spk_c"]


def test_bench_audionet_entry_prints_one_result_line(capsys):
    """python -m speakerguard_tpu_torch.bench --model audionet on the CPU
    at a tiny size: one JSON line named as the JAX bench names it."""
    assert bench.main(["--model", "audionet", "--device", "cpu", "--batch",
                       "2", "--wav-len", "8000", "--iters", "2", "--warmup",
                       "0", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "pgd2_audionet_utts_per_sec"
    assert rec["batch"] == 2 and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["fast_path"] is None
    assert 0.0 <= rec["attack_success_rate_pct"] <= 100.0


@pytest.mark.cuda
def test_card_bf16_against_cpu_f32():
    """The card's default fast path (bf16 DFT and bf16 CNN) against the CPU
    exact path on the same weights: scores and the waveform gradient at
    JAX's bar for bf16 against f32 (scores within 0.08 of their spread,
    cosine 0.9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jax_pair = jax_an.init_audionet(np.random.default_rng(40), 6)
    wavs = _wavs(41)
    card = an.AudioNet(*from_jax_params(jax.tree.map(np.asarray, jax_pair),
                                        device="cuda"))
    assert card.fast_path == FastPath()
    x = torch.tensor(wavs, device="cuda", requires_grad=True)
    s = card.score(x, fast=True)
    s[:, :2].sum().backward()
    got, g = s.detach().cpu().numpy(), x.grad.cpu().numpy()
    want, g_want = _fast_score_and_grad(
        an.AudioNet(*_carry(jax_pair), fast=FastPath(enabled=False)), wavs)
    assert np.isfinite(got).all() and np.isfinite(g).all()
    assert np.abs(got - want).max() < 0.08 * max(np.abs(want).max(), 1.0)
    assert _cos(g, g_want) > 0.9
