"""models/ecapa.py: EcapaCos against the plain float32 reference
tests/ecapa_reference.py, on seeded random weights at a small size (C = 64,
Res2 scale 8, SE and attention bottleneck 16, MFA 96, embedding 24, 80 mel
bins and cepstra, 1.2 s waves: 120 frames).

Bars:
- the exact float32 path (embeddings, scores, the PGD loss's waveform
  gradient) within 1e-5 of the largest entry: the same float32 sums in
  another order (im2col GEMMs against F.conv1d; the BN as r a + c against
  (r - mean) / sqrt(var + eps) gamma + beta); measured up to 2e-6;
- the bf16 fast path (``FastPath()``; on the CPU the plain bf16 blocks)
  within 4 bf16 ulps of the largest score or embedding entry (4 x 2^-8):
  its activations carry 8 significant bits through 30 blocks, and their
  roundings mostly cancel in the pooling (measured 2.7e-3 at this size).
  It has to fail the exact bar, or the path would not be the bf16 one.
  Its waveform gradient: cosine 0.995 and sign agreement 0.97 against the
  reference's (measured 0.998 and 0.986; the x-vector's bf16 bars, 0.998
  and 0.98, leave no room for ECAPA's 18 dependent Res2 branches).

The model's flag ladder is the x-vector's (0 wav, 1 raw MFCC, 2 CMN):
its front end has no delta step, so level 3 is refused.  The file runs on
one CPU thread and imports no JAX; ``-m cuda`` runs its card cases.
"""

import os

import numpy as np
import pytest
import torch

import ecapa_reference as R
from speakerguard_tpu_torch.models import ecapa as E
from speakerguard_tpu_torch.models.base import FastPath, tree_leaves
from speakerguard_tpu_torch.ops import asp_pool as AP
from speakerguard_tpu_torch.ops import tdnn_conv as TC
from speakerguard_tpu_torch.ops.kaldi_mfcc import MfccConfig

from test_torch_tdnn_conv import emulated, one_cpu_thread  # noqa: F401

SMALL = dict(channels=64, se_channels=16, attention=16, mfa=96, emb=24)
SPEAKERS = 5
EXACT = 1e-5
BF16 = 4 * 2.0 ** -8


@pytest.fixture(scope="module")
def params():
    return E.random_ecapa_params(np.random.default_rng(11), device="cpu",
                                 **SMALL)


@pytest.fixture(scope="module")
def state(params):
    return E.ecapa_torch_state(params)


@pytest.fixture(scope="module")
def enrolled():
    return torch.tensor(np.random.default_rng(12).standard_normal(
        (SPEAKERS, SMALL["emb"])), dtype=torch.float32)


def _model(params, enrolled, fast, **kw):
    m = E.EcapaCos(params, fast=fast, **kw)
    m.set_enrollment([str(i) for i in range(SPEAKERS)], enrolled)
    return m


@pytest.fixture(scope="module")
def exact(params, enrolled):
    return _model(params, enrolled, FastPath(enabled=False))


@pytest.fixture(scope="module")
def fast(params, enrolled):
    return _model(params, enrolled, FastPath())


@pytest.fixture(scope="module")
def waves():
    """Three 1.2 s waves in the int16 range (the model's origin domain)."""
    return torch.tensor(np.random.default_rng(13).uniform(
        -0.3, 0.3, (3, 19200)), dtype=torch.float32) * 32768.0


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("flag", [0, 1, 2])
def test_embedding_matches_reference_at_each_flag(exact, state, waves, flag):
    """The embedding from each level of the feature ladder: the wave, the
    raw MFCC (the model adds the CMN), the CMN features."""
    feats = exact.compute_feat(waves, flag=2)
    inputs = {0: waves, 1: exact.compute_feat(waves, flag=1), 2: feats}
    with torch.no_grad():
        got = exact.embedding(inputs[flag], flag=flag)
        want = R.embedding(state, feats)
    assert got.shape == (3, SMALL["emb"])
    assert _rel(got, want) <= EXACT


def test_flag_beyond_the_ladder_is_refused(exact, waves):
    with pytest.raises(AssertionError):
        exact.embedding(waves, flag=3)


def test_scores_match_reference(exact, state, enrolled, waves):
    with torch.no_grad():
        got = exact.score(waves)
        want = R.scores(state, exact.compute_feat(waves, flag=2), enrolled)
    assert got.shape == (3, SPEAKERS)
    assert _rel(got, want) <= EXACT


def _ce_grad(score_fn, waves, y):
    x = waves.clone().requires_grad_(True)
    loss = torch.nn.functional.cross_entropy(score_fn(x), y, reduction="sum")
    (g,) = torch.autograd.grad(loss, x)
    return g


def _ref_score_fn(model, state, enrolled):
    """The reference network on the port's front end (tested against the
    JAX package's on its own), differentiable in the wave."""
    return lambda x: R.scores(state, model.compute_feat(x, flag=2), enrolled)


def test_exact_input_gradient_matches_reference(exact, state, enrolled,
                                                waves):
    """The waveform gradient of PGD's loss (the cross-entropy of the
    scores) on the exact path."""
    y = torch.tensor([0, 3, 1])
    got = _ce_grad(exact.score, waves, y)
    want = _ce_grad(_ref_score_fn(exact, state, enrolled), waves, y)
    assert _rel(got, want) <= EXACT


@pytest.mark.parametrize("what", ["embedding", "scores"])
def test_fast_path_is_bf16_close(fast, exact, state, enrolled, waves, what):
    with torch.no_grad():
        feats = exact.compute_feat(waves, flag=2)
        if what == "embedding":
            got = fast.embedding(waves, fast=True)
            want = R.embedding(state, feats)
        else:
            got = fast.score(waves, fast=True)
            want = R.scores(state, feats, enrolled)
    err = _rel(got, want)
    assert EXACT < err <= BF16, err


def test_fast_path_gradient_follows_the_reference(fast, exact, state,
                                                  enrolled, waves):
    y = torch.tensor([2, 0, 4])
    g = _ce_grad(lambda x: fast.score(x, fast=True), waves, y)
    gw = _ce_grad(_ref_score_fn(exact, state, enrolled), waves, y)
    g, gw = g.flatten().double(), gw.flatten().double()
    assert torch.dot(g, gw) / (g.norm() * gw.norm()) >= 0.995
    assert (torch.sign(g) == torch.sign(gw)).double().mean() >= 0.97


@pytest.mark.parametrize("threshold", [None, "between"])
def test_csi_decisions(params, enrolled, state, waves, threshold):
    """CSI-E: the argmax of the reference's scores; with a threshold, -1
    where the best score is below it."""
    ref = _model(params, enrolled, FastPath(enabled=False))
    with torch.no_grad():
        want = R.scores(state, ref.compute_feat(waves, flag=2), enrolled)
    best = want.max(1).values
    low = best.sort().values
    # midway between the two lowest best scores: one row rejected
    thr = None if threshold is None else float(low[:2].mean())
    model = _model(params, enrolled, FastPath(enabled=False), threshold=thr)
    dec, scores = model.make_decision(waves)
    expect = want.argmax(1).to(torch.int32)
    if thr is not None:
        expect = torch.where(best > thr, expect, -1)
        assert (dec == -1).any() and (dec != -1).any()
    assert torch.equal(dec, expect)
    assert _rel(scores, want) <= EXACT


def test_pgd_runs_on_the_fast_path_and_decides_exactly(params, enrolled):
    """PGD-3 (attacks/gradient.py) on the fast path, no dither: the waves
    stay in the epsilon box, and each success is the exact path's
    decision on the returned wave."""
    from speakerguard_tpu_torch.attacks import PGD
    model = _model(params, enrolled, FastPath(),
                   mfcc_config=MfccConfig(num_mel_bins=80, num_ceps=80,
                                          dither=0.0))
    x = torch.tensor(np.random.default_rng(14).uniform(-0.3, 0.3,
                                                       (3, 19200)),
                     dtype=torch.float32)
    y = torch.tensor([1, 2, 3])
    adv, success = PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
                       max_iter=3, loss="Entropy").attack(x, y, rng=0)
    adv = adv.reshape(x.shape)
    assert float((adv - x).abs().max()) <= 0.002 + 1e-7
    dec, _ = model.make_decision(adv * 32768.0)
    assert list(success) == (dec != y.to(torch.int32)).tolist()


def test_state_dict_round_trip(params, state):
    """The state dict holds SpeechBrain's ECAPA_TDNN names and layouts, and
    reads back to the same weights."""
    c, mfa, emb = SMALL["channels"], SMALL["mfa"], SMALL["emb"]
    assert state["blocks.0.conv.conv.weight"].shape == (c, 80, 5)
    assert state["blocks.2.res2net_block.blocks.6.norm.norm.running_var"] \
        .shape == (c // 8,)
    assert state["blocks.3.se_block.conv2.conv.weight"].shape == (c, 16, 1)
    assert state["asp.tdnn.conv.conv.weight"].shape == (16, 3 * mfa, 1)
    assert state["asp_bn.norm.weight"].shape == (2 * mfa,)
    assert state["fc.conv.weight"].shape == (emb, 2 * mfa, 1)
    back = E.load_ecapa_from_torch_state(
        {k: v.numpy() for k, v in state.items()}, device="cpu")
    for (name, a), (_, b) in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b), name


def test_kernel_route_model_matches_plain_route(params, enrolled, waves,
                                                emulated):
    """The whole model on the kernel route (each launch emulated): 30
    launches a direction, each padded block's input gathered and its
    cotangent folded, the 1x1 blocks reading their inputs in place; the
    embedding within 2e-3 of the plain route's largest entry and the
    waveform gradient at cosine 0.998, the x-vector's bars for the same
    comparison."""
    model = _model(params, enrolled, FastPath())
    y = torch.tensor([0, 1, 2])

    def run():
        x = waves.clone().requires_grad_(True)
        emb = model.embedding(x, fast=True)
        loss = torch.nn.functional.cross_entropy(
            E.cosine_scores(emb, enrolled), y, reduction="sum")
        (g,) = torch.autograd.grad(loss, x)
        return emb.detach(), g

    emb, grad = run()
    assert emulated.launches == 60
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(emulated, "route", lambda t: False)
        want, want_grad = run()
    assert torch.isfinite(emb).all() and torch.isfinite(grad).all()
    assert (emb - want).abs().max() <= 2e-3 * want.abs().max()
    g, gw = grad.flatten().double(), want_grad.flatten().double()
    assert torch.dot(g, gw) / (g.norm() * gw.norm()) >= 0.998


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_res2_node_equals_per_block_chain(params, route, emulated,
                                          monkeypatch):
    """The fast path's Res2 chain as one autograd node against the same
    chain of ``_tb_fast`` blocks under autograd: output and input
    cotangent bit for bit, on the plain route and on the kernel route
    (each launch emulated): the same launches, adds and cat."""
    blk = params.blocks[1]
    gen = torch.Generator().manual_seed(21)
    u = torch.randn(2, 40, SMALL["channels"], generator=gen).to(
        torch.bfloat16)
    gy = torch.randn(u.shape, generator=gen).to(torch.bfloat16)
    if route == "plain":
        monkeypatch.setattr(emulated, "route", lambda t: False)

    def run(fn):
        x = u.clone().requires_grad_(True)
        y = fn(x)
        (gx,) = torch.autograd.grad(y, x, gy)
        return y.detach(), gx

    want = run(lambda x: E._res2(x, blk.res2, 3, E._tb_fast))
    launches = emulated.launches
    got = run(lambda x: E._Res2FastBf16.apply(x, blk.res2, 3))
    if route == "kernel":
        assert emulated.launches - launches == launches == 14
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_attack_main_runs_ecapa(params, tmp_path, capsys):
    """The ``ecapa`` system type through the port's CLIs: a state dict of
    random weights under SpeechBrain's names, enrolled by ``enroll``, then
    ``attack_main`` PGD on the CPU; one wave written per utterance, each
    within epsilon of its input (and an int16 step of rounding)."""
    from fixtures import make_wav_dataset
    from speakerguard_tpu_torch.cli import attack_main, enroll
    from speakerguard_tpu_torch.utils.audio_io import read_wav
    rng = np.random.default_rng(15)
    data = tmp_path / "data"
    for name in ("Spk10_enroll", "Spk10_test"):
        make_wav_dataset(str(data), rng, name=name, n_spks=2,
                         utts_per_spk=1, length=8000)
    ckpt = tmp_path / "embedding_model.ckpt"
    torch.save(E.ecapa_torch_state(params), ckpt)
    system = ["ecapa", "-extractor", str(ckpt)]
    enroll.main(enroll.parse_args(["-model_dir", str(tmp_path / "model"),
                                   "-root", str(data), "-device", "cpu"]
                                  + system))
    model_file = tmp_path / "model" / "ecapa" / "speaker_model_ecapa"
    assert model_file.exists()
    des = tmp_path / "adver"
    out = attack_main.main(attack_main.parse_args(
        ["-root", str(data), "-name", "Spk10_test", "-des", str(des),
         "-batch_size", "2", "-wav_length", "8000", "-device", "cpu"]
        + system + ["-model_file", str(model_file), "PGD", "-max_iter",
                    "2"]))
    capsys.readouterr()
    assert sorted(out["success"]) == ["spk0-0", "spk1-0"]
    for name in out["success"]:
        spk = name.split("-")[0]
        adv = read_wav(os.path.join(des, spk, name + ".wav"))
        ori = read_wav(os.path.join(data, "Spk10_test", spk, name + ".wav"))
        assert np.abs(adv - ori).max() <= 0.002 + 1.0 / 32768


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_model():
    rng = np.random.default_rng(16)
    model = E.EcapaCos(E.random_ecapa_params(rng, device="cuda"),
                       fast=FastPath())
    model.set_enrollment([str(i) for i in range(10)], torch.tensor(
        rng.standard_normal((10, 192)), dtype=torch.float32, device="cuda"))
    return model


@pytest.mark.cuda
def test_pgd10_launches_tdnn_conv_30_times_a_direction():
    """PGD-10 at the published widths, FastPath(): every TB block of each
    iteration's forward and input gradient on the kernel (30 + 30), the
    pooling's statistics on theirs (1 + 1), the final evaluation exact."""
    _need_card()
    from speakerguard_tpu_torch.attacks import PGD
    model = _card_model()
    x = torch.tensor(np.random.default_rng(17).uniform(
        -0.3, 0.3, (4, 16000)), dtype=torch.float32, device="cuda")
    w, pool = TC.tdnn_conv, AP.asp_stats
    w.reset_counts()
    pool.reset_counts()
    PGD(model, task="CSI", epsilon=0.002, step_size=0.0004, max_iter=10,
        loss="Entropy").attack(x, torch.zeros(4, dtype=torch.long,
                                              device="cuda"), rng=0)
    torch.cuda.synchronize()
    assert (w.launches, w.plain_calls) == (600, 0)
    assert (pool.launches, pool.plain_calls) == (20, 0)


@pytest.mark.cuda
def test_gradient_through_the_kernel_matches_the_plain_route(monkeypatch):
    """The waveform gradient at the published widths through the kernel
    against the blocks' plain version on the card, at the CPU case's
    bar."""
    _need_card()
    model = _card_model()
    x0 = torch.tensor(np.random.default_rng(18).uniform(
        -0.3, 0.3, (4, 16000)), dtype=torch.float32, device="cuda") * 32768

    def grad():
        x = x0.clone().requires_grad_(True)
        model.score(x, fast=True)[:, 0].sum().backward()
        return x.grad.flatten().double()

    g = grad()
    monkeypatch.setattr(TC.tdnn_conv, "route", lambda t: False)
    gw = grad()
    assert torch.dot(g, gw) / (g.norm() * gw.norm()) >= 0.998
