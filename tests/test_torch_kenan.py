"""The port's SSA (ops/ssa.py) and Kenansville attack (attacks/kenan.py)
against the JAX package's, on the same weights and waves.

Models: small iv-PLDA (C=64, D=72, IV=32, R=16, as
tests/test_torch_tasks.py) and xv-PLDA at the full TDNN widths (as
tests/test_torch_xv_plda.py), five enrolled speakers, task CSI, dither 0
(the two frameworks draw different dither), four waves of rising amplitude
of 6,000 samples (SSA window 300; the TDNN needs 31 frames), labelled with
the model's own clean decisions; targeted runs aim at the next speaker.
The JAX side runs as it always does: the fft search as one jitted scan,
each ssa step jitted.

Bars:

- the float64 oracle (``ssa``, ``inv_ssa``, ``ssa_compress``) equal to
  JAX's, the same numpy code;
- the device reconstruction (f32 SVD, masked product, anti-diagonal means)
  within 1e-4 of max |x| of the float64 oracle, for every keep, and the
  full keep giving the wave back;
- the success vectors of Kenan fft and ssa identical to JAX's (targeted and
  untargeted; ssa with early stop off and on, on the device and on the
  host oracle), the ssa keep counts of every step identical, and the
  adversarial waves within 1e-4 (fft: the FFTs differ by an ulp) or equal
  (ssa on the host oracle, where both packages run the same float64
  numpy);
- a batch equal to its waves one at a time (ssa, device path).
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import kenan as jkenan
from speakerguard_tpu.attacks.kenan import Kenan as JaxKenan
from speakerguard_tpu.models.iv_plda import IvPlda as JaxIvPlda
from speakerguard_tpu.models.iv_plda import random_iv_plda_params
from speakerguard_tpu.models.xv_plda import XvPlda as JaxXvPlda
from speakerguard_tpu.models.xv_plda import random_xv_plda_params
from speakerguard_tpu.ops import ssa as jssa
from speakerguard_tpu.ops.kaldi_mfcc import IV_PLDA_MFCC as JAX_IV_MFCC
from speakerguard_tpu.ops.kaldi_mfcc import XV_PLDA_MFCC as JAX_XV_MFCC

from speakerguard_tpu_torch.attacks import Kenan
from speakerguard_tpu_torch.attacks.kenan import fft_compression
from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models.iv_plda import IvPlda
from speakerguard_tpu_torch.models.xv_plda import XvPlda
from speakerguard_tpu_torch.ops import ssa as ssa_mod
from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC, XV_PLDA_MFCC

SPK = [str(i) for i in range(5)]
LENGTH = 6000


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """This file's tests run on one CPU thread, torch's and the BLAS
    libraries' alike, restored after the file.  Under the parallel test
    run (six workers on eight cores) their SVDs and small products spent
    most of their time in spinning thread pools: beside ten busy
    processes on eight cores, one case took 121 s with eight threads and
    8.5 s with one.  The card's machine has no threadpoolctl: there
    torch's threads alone are limited."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if threadpool_limits is None:
            yield
        else:
            with threadpool_limits(limits=1):
                yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    """{kind: (JAX model, port model, waves, clean decisions)}."""
    out = {}
    rng = np.random.default_rng(99)
    iv = random_iv_plda_params(rng, num_gaussians=64, dim=72, ivector_dim=32,
                               reduced_dim=16)
    enroll = rng.standard_normal((5, 16)).astype(np.float32)
    out["iv"] = (JaxIvPlda(iv, mfcc_config=dataclasses.replace(
        JAX_IV_MFCC, dither=0.0)), IvPlda(from_jax_params(
            jax.tree.map(np.asarray, iv), device="cpu"),
        mfcc_config=dataclasses.replace(IV_PLDA_MFCC, dither=0.0)), enroll)
    rng = np.random.default_rng(1234)
    xv = random_xv_plda_params(rng)
    pm = XvPlda(from_jax_params(jax.tree.map(np.asarray, xv), device="cpu"),
                mfcc_config=dataclasses.replace(XV_PLDA_MFCC, dither=0.0))
    # speakers near the embeddings of waves like the attacked ones (as
    # tests/test_torch_defended.py enrolls them), so that compression moves
    # the decisions
    enroll_wavs = (np.random.default_rng(3).uniform(-1, 1, (5, LENGTH))
                   * np.array([0.03, 0.06, 0.1, 0.2, 0.3])[:, None])
    with torch.no_grad():
        enroll = pm.embedding(torch.tensor(enroll_wavs, dtype=torch.float32))
    enroll = (enroll.numpy() + 0.1 * rng.standard_normal((5, 150))).astype(
        np.float32)
    out["xv"] = (JaxXvPlda(xv, mfcc_config=dataclasses.replace(
        JAX_XV_MFCC, dither=0.0)), pm, enroll)
    scale = np.array([0.05, 0.1, 0.2, 0.3])[:, None]
    wavs = (np.random.default_rng(11).uniform(-1, 1, (4, LENGTH)) * scale
            ).astype(np.float32)
    res = {}
    for kind, (jm, pm, enroll) in out.items():
        jm.set_enrollment(SPK, enroll)
        pm.set_enrollment(SPK, enroll)
        labels = np.asarray(jm.make_decision(jnp.asarray(wavs))[0])
        with torch.no_grad():
            assert np.array_equal(pm.make_decision(torch.tensor(wavs))[0]
                                  .numpy(), labels)
        res[kind] = (jm, pm, wavs, labels)
    return res


def _speech(seed, n=2000):
    t = np.arange(n) / 16000.0
    return (12000 * np.sin(2 * np.pi * 250 * t)
            + 3000 * np.sin(2 * np.pi * 1300 * t)
            + 500 * np.random.default_rng(seed).standard_normal(n))


# ---- SSA -------------------------------------------------------------------

def test_ssa_oracle_equals_jax():
    x = _speech(0)
    for got, want in zip(ssa_mod.ssa(x, 100), jssa.ssa(x, 100)):
        np.testing.assert_array_equal(got, want)
    pc, _, v = jssa.ssa(x, 100)
    np.testing.assert_array_equal(ssa_mod.inv_ssa(pc, v, np.arange(7)),
                                  jssa.inv_ssa(pc, v, np.arange(7)))
    np.testing.assert_array_equal(ssa_mod.ssa_compress(x, 3, 50),
                                  jssa.ssa_compress(x, 3, 50))


@pytest.mark.parametrize("window", [100, 200])
def test_ssa_device_reconstruction_matches_oracle(window):
    """A batch of two waves, each lane its own keep."""
    x = np.stack([_speech(1, 4000), _speech(2, 4000)[::-1]])
    pc, s, v = ssa_mod.ssa_device(torch.tensor(x, dtype=torch.float32),
                                  window)
    assert pc.shape == (2, window, window) and v.shape == (
        2, 4000 - window + 1, window)
    oracle = [jssa.ssa(x[i], window) for i in range(2)]
    np.testing.assert_allclose(s.numpy(), [o[1] for o in oracle],
                               rtol=1e-4, atol=1e-3 * oracle[0][1][0])
    for keeps in ([1, 4], [32, 7], [window, window]):
        got = ssa_mod.inv_ssa_masked(pc, v, torch.tensor(keeps)).numpy()
        for i in range(2):
            want = jssa.inv_ssa(oracle[i][0], oracle[i][2],
                                np.arange(keeps[i]))
            assert np.abs(got[i] - want).max() <= 1e-4 * np.abs(x[i]).max()
            if keeps[i] == window:
                assert np.abs(got[i] - x[i]).max() <= 1e-4 * np.abs(
                    x[i]).max()


def test_anti_diagonal_mean_is_the_bincount_average():
    traj = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 6, 11)), dtype=torch.float64)
    idx = (np.arange(6)[:, None] + np.arange(11)[None, :]).ravel()
    counts = np.bincount(idx)
    for b in range(2):
        want = np.bincount(idx, traj[b].numpy().ravel()) / counts
        np.testing.assert_allclose(
            ssa_mod.anti_diagonal_mean(traj)[b].numpy(), want, rtol=1e-12)


# ---- Kenan fft -------------------------------------------------------------

def test_fft_compression_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 1000)).astype(
        np.float32)
    factor = np.array([20.0, 35.0], np.float32)
    want = np.asarray(jkenan.fft_compression(jnp.asarray(x),
                                             jnp.asarray(factor)))
    got = fft_compression(torch.tensor(x), torch.tensor(factor)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _labels(world, targeted):
    labels = world[3]
    return (labels + 1) % len(SPK) if targeted else labels


@pytest.mark.parametrize("kind,targeted", [("iv", False), ("iv", True),
                                           ("xv", False)])
def test_kenan_fft_matches_jax(worlds, kind, targeted):
    jm, pm, wavs, _ = worlds[kind]
    y = _labels(worlds[kind], targeted)
    jadv, jsucc = JaxKenan(jm, atk_name="fft", max_iter=8,
                           targeted=targeted).attack(
        jnp.asarray(wavs), jnp.asarray(y), rng=jax.random.PRNGKey(0))
    adv, succ = Kenan(pm, atk_name="fft", max_iter=8,
                      targeted=targeted).attack(torch.tensor(wavs),
                                                torch.tensor(y), rng=0)
    assert succ == jsucc
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-4)


# ---- Kenan ssa -------------------------------------------------------------

def _jax_ssa(jm, wavs, y, device, **kw):
    """JAX's ssa attack and its keep counts, step by step: the device
    path's jitted step (built by a first run) and the host path's inv_ssa,
    each wrapped to record the keep it is given."""
    keeps = []
    atk = JaxKenan(jm, atk_name="ssa", **kw)
    run = lambda: atk.attack(jnp.asarray(wavs), jnp.asarray(y),  # noqa: E731
                             rng=jax.random.PRNGKey(0))
    if device:
        run()
        step = atk._ssa_step

        def recording(params, pc, v, keep, key):
            keeps.append(np.asarray(keep).tolist())
            return step(params, pc, v, keep, key)

        atk._ssa_step = recording
        return (*run(), keeps)
    lanes = []

    def inv_ssa(pc, v, indices):
        lanes.append(len(indices))
        return jssa.inv_ssa(pc, v, indices)

    orig = jkenan.inv_ssa
    jkenan.inv_ssa = inv_ssa
    try:
        adv, succ = run()
    finally:
        jkenan.inv_ssa = orig
    b = len(wavs)
    return adv, succ, [lanes[i:i + b] for i in range(0, len(lanes), b)]


def _port_ssa(pm, wavs, y, device, **kw):
    atk = Kenan(pm, atk_name="ssa", ssa_device=device, **kw)
    keeps, inv = [], ssa_mod.inv_ssa_masked if device else ssa_mod.inv_ssa
    import speakerguard_tpu_torch.attacks.kenan as kenan_mod
    name = "inv_ssa_masked" if device else "inv_ssa"

    def recording(pc, v, keep):
        keeps.append(keep.tolist() if device else len(keep))
        return inv(pc, v, keep)

    setattr(kenan_mod, name, recording)
    try:
        adv, succ = atk.attack(torch.tensor(wavs), torch.tensor(y), rng=0)
    finally:
        setattr(kenan_mod, name, inv)
    if not device:
        b = len(wavs)
        keeps = [keeps[i:i + b] for i in range(0, len(keeps), b)]
    assert atk.last_executed_steps == len(keeps)
    return adv, succ, keeps


SSA_CASES = [  # kind, targeted, early_stop, device
    ("iv", False, False, True), ("iv", True, True, True),
    ("xv", False, True, True), ("iv", False, True, False)]


@pytest.mark.parametrize("kind,targeted,early_stop,device", SSA_CASES)
def test_kenan_ssa_matches_jax(worlds, monkeypatch, kind, targeted,
                               early_stop, device):
    jm, pm, wavs, _ = worlds[kind]
    y = _labels(worlds[kind], targeted)
    kw = dict(max_iter=6, targeted=targeted, early_stop=early_stop)
    monkeypatch.setenv("SG_SSA_DEVICE", "1" if device else "0")
    jadv, jsucc, jkeeps = _jax_ssa(jm, wavs, y, device, **kw)
    adv, succ, keeps = _port_ssa(pm, wavs, y, device, **kw)
    assert keeps == jkeeps
    assert succ == jsucc
    if device:
        np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-4)
    else:
        np.testing.assert_array_equal(adv.numpy(), np.asarray(jadv))


def test_kenan_ssa_batched_equals_per_wave(worlds):
    _, pm, wavs, labels = worlds["iv"]
    kw = dict(atk_name="ssa", max_iter=5, early_stop=True)
    adv, succ = Kenan(pm, **kw).attack(torch.tensor(wavs),
                                       torch.tensor(labels), rng=0)
    for i in range(len(wavs)):
        a1, s1 = Kenan(pm, **kw).attack(torch.tensor(wavs[i:i + 1]),
                                        torch.tensor(labels[i:i + 1]),
                                        rng=0)
        assert s1 == [succ[i]]
        np.testing.assert_allclose(a1[0].numpy(), adv[i].numpy(),
                                   atol=1e-6)


def test_bench_kenan_ssa_entry_prints_one_result_line(capsys):
    """python -m speakerguard_tpu_torch.bench --attack kenan_ssa on the CPU
    at a tiny size: one JSON line named as bench.py names it."""
    from speakerguard_tpu_torch import bench
    assert bench.main(["--model", "audionet", "--attack", "kenan_ssa",
                       "--device", "cpu", "--batch", "2", "--wav-len",
                       "4000", "--kenan-iters", "2", "--warmup", "0",
                       "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "kenan_ssa2_audionet_utts_per_sec"
    assert rec["unit"] == "utterances/sec" and rec["value"] > 0
    assert rec["batch"] == 2 and rec["wav_len"] == 4000
    assert rec["executed_steps"] == 2
    assert 0.0 <= rec["attack_success_rate_pct"] <= 100.0
