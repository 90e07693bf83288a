"""The port's data parallelism (speakerguard_tpu_torch/parallel/) against its
one-process runs and the JAX package's sharded steps.

Ranks are processes spawned by ``parallel.mesh.spawn`` with gloo on the
CPU, joined through a FileStore in a temporary directory; each runs the
functions of tests/_torch_dp_worker.py, which import only the port.  The
parent runs the same functions without a process group (the one-process
port) and JAX's references, and compares.  Two spawns: two ranks for the
train steps, the attacks under ``mesh=`` and the input pipeline; four
ranks (a 2 x 2 (data, eot) mesh) for the EOT and NES gradients.

Bars:

- DP train steps (tests/test_parallel.py:18-97's sizes: SGD 0.1, natural
  8 x 4,000, adversarial 16 x 4,000 with PGD-2): against the one-process
  port step, the loss and the gradient's loss rtol 1e-6, the accuracies
  equal, the BN running stats atol 1e-6, every gradient leaf and every
  updated parameter within 1e-5 of its scale, the larger of its largest
  entry and 1% of its tree's (SGD moves each by 0.1 g: the gradient's bar
  at lr scale), the sums reordered by the all-reduce; against JAX's
  ``sharded_train_step`` on its 8 virtual devices with the same draws,
  the loss rtol 1e-5 and the accuracies equal, JAX's bars.  Parameters are
  not compared with JAX's jitted step, whose train-mode gradient is wrong
  on the CPU (tests/test_torch_training.py).  With Adam the two ranks'
  parameters are equal bit for bit.
- ``sharded_attack_grad`` and ``sharded_nes_grad`` against
  ``adaptive.eot`` / ``adaptive.nes`` on the whole batch: rtol 1e-4 atol
  1e-6 and rtol 1e-3 atol 1e-4, JAX's bars (tests/test_parallel.py:99-121,
  178-218).
- Attacks under ``mesh=`` against the one-process attack with the same
  generator: the success lists equal; the audio within 1e-6 on the toy
  and xv models; on iv at most 1e-3 of the samples differ and each within
  2 eps (tests/test_parallel.py:220-409), and so FAKEBOB on xv (a batch
  of 2 and one of 4 score at ULP distance, which NES's differences over
  sigma = 1e-3 carry into the gradient's sign: measured 23 of 32,000
  samples, one step apart); CW2's consts and the black-box
  loops' trip counts equal; the shared top-K selection the same on both
  ranks and equal to the one-process one.
- ``host_sharded_batches``: the ranks' rows put together equal JAX's
  global batches (Dataset.batches and JAX's host_sharded_batches) exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from speakerguard_tpu.data.dataset import Dataset as JaxDataset
from speakerguard_tpu.models import audionet as jax_an
from speakerguard_tpu.models import training as jt
from speakerguard_tpu.parallel.input import \
    host_sharded_batches as jax_host_sharded_batches
from speakerguard_tpu.parallel.mesh import (make_mesh as jax_make_mesh,
                                            replicate as jax_replicate,
                                            shard_batch as jax_shard_batch,
                                            sharded_train_step as
                                            jax_sharded_train_step)

from speakerguard_tpu_torch.parallel.input import prefetch
from speakerguard_tpu_torch.parallel.mesh import BatchShard, spawn

import _torch_dp_worker as W
from fixtures import make_wav_dataset
from test_torch_kenan import one_cpu_thread  # noqa: F401

ATTACKS = ("pgd_toy", "pgd_toy_restarts", "fgsm_toy", "cw2_toy",
           "fakebob_toy", "siren_toy", "pgd_xv", "fakebob_xv", "siren_xv",
           "pgd_iv", "pgd_iv_topk")
# the cases held to the iv contract: the model's scores differ at ULP level
# between batch sizes (iv's solve chain; xv's TDNN GEMMs, which NES's
# finite differences over sigma = 1e-3 amplify)
ULP_CASES = ("pgd_iv", "pgd_iv_topk", "fakebob_xv")


def _spawn(fn, world, *args):
    return spawn(fn, world, args, backend="gloo", timeout_s=300)


def _jax_draws(key, shape, adver):
    """JAX's step draws under ``key``: the scale a and the noise."""
    if adver:
        _, k1, k2 = jax.random.split(key, 3)
    else:
        k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, ())),
            np.asarray(jax.random.uniform(k2, shape, jnp.float32)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs (.npy files in ``data``), the dataset, and JAX's sharded
    steps' loss and accuracies."""
    data = tmp_path_factory.mktemp("dp_data")
    rng = np.random.default_rng(0)
    save = lambda name, a: np.save(data / f"{name}.npy", a)  # noqa: E731
    nat_wavs = rng.uniform(-0.3, 0.3, (8, 4000)).astype(np.float32)
    nat_labels = rng.integers(0, 4, 8)
    adv_wavs = rng.uniform(-0.3, 0.3, (16, 4000)).astype(np.float32)
    adv_labels = rng.integers(0, 4, 16)
    k_nat, k_adv = jax.random.PRNGKey(4), jax.random.PRNGKey(6)
    nat_a, nat_noise = _jax_draws(k_nat, (8, 4000), False)
    adv_a, adv_noise = _jax_draws(k_adv, (8, 4000), True)
    for name, a in (("nat_wavs", nat_wavs), ("nat_labels", nat_labels),
                    ("adv_wavs", adv_wavs), ("adv_labels", adv_labels),
                    ("nat_a", nat_a), ("nat_noise", nat_noise),
                    ("adv_a", adv_a), ("adv_noise", adv_noise)):
        save(name, a)

    # JAX's sharded steps on its 8 virtual devices, from the same weights
    params, state = jax_an.init_audionet(np.random.default_rng(0), 4)
    opt = optax.sgd(0.1)
    mesh = jax_make_mesh(8, axes=("data",))
    rep = lambda t: jax_replicate(t, mesh)  # noqa: E731
    nat = jax_sharded_train_step(
        jt.make_natural_train_step(opt, aug_eps=0.002), mesh)
    out = nat(rep(params), rep(state), rep(opt.init(params)),
              jax_shard_batch(jnp.asarray(nat_wavs), mesh),
              jax_shard_batch(jnp.asarray(nat_labels), mesh), k_nat)
    jax_ref = {"nat": dict(loss=float(out[3]), acc=float(out[4]))}
    attack = jt.make_pgd_for_training(epsilon=0.01, step_size=0.004,
                                      max_iter=2)
    adv = jax_sharded_train_step(
        jt.make_adver_train_step(opt, attack, ratio=0.5, aug_eps=0.002),
        mesh)
    out = adv(rep(params), rep(state), rep(opt.init(params)),
              jax_shard_batch(jnp.asarray(adv_wavs), mesh),
              jax_shard_batch(jnp.asarray(adv_labels), mesh), k_adv)
    jax_ref["adv"] = dict(loss=float(out[3]), acc_adv=float(out[4]),
                          acc_nor=float(out[5]))

    # the attacks' waves: toy 8 x 4,000, xv 4 x 8,000, iv 8 x 8,000,
    # labelled with the clean decisions on xv and iv
    save("toy_x", rng.uniform(-0.3, 0.3, (8, 4000)).astype(np.float32))
    save("toy_y", rng.integers(0, 4, 8))
    for kind, n, build in (("xv", 4, W._xv_model),
                           ("iv", 8, lambda: W._iv_model(None))):
        x = rng.uniform(-0.3, 0.3, (n, 8000)).astype(np.float32)
        save(f"{kind}_x", x)
        save(f"{kind}_y", build().make_decision(torch.tensor(x))[0].numpy())

    # the EOT / NES gradients' inputs
    save("x", rng.uniform(-0.3, 0.3, (8, 4000)).astype(np.float32))
    save("y", rng.integers(0, 4, 8))
    save("noise", rng.standard_normal((4, 8, 4000)).astype(np.float32))

    root, name, spks = make_wav_dataset(
        str(tmp_path_factory.mktemp("dp_wavs")), rng, n_spks=4,
        utts_per_spk=4, length=6000)
    return dict(data=str(data), jax=jax_ref, dataset=(root, name, spks))


@pytest.fixture(scope="module")
def two_ranks(world):
    """Both ranks' results of the train steps, the attacks and the input
    pipeline."""
    root, name, spks = world["dataset"]
    return _spawn(W.two_rank_jobs, 2, world["data"], root, name, spks,
                  ATTACKS)


@pytest.fixture(scope="module")
def one_process(world):
    from speakerguard_tpu_torch.parallel import rank_checks
    return {"train": W.train_steps(world["data"]),
            "attacks": W.attacks(world["data"], ATTACKS),
            "rank_checks": (rank_checks.dp_natural_step(*W.RANK_CHECK_STEP),
                            rank_checks.dp_natural_step(*W.RANK_CHECK_STEP,
                                                        f64=True),
                            rank_checks.sharded_pgd_iv(
                                *W.rank_check_pgd()))}


def _leaves_close(got, want, rel):
    """Each leaf within ``rel`` of its scale: the larger of its largest
    |entry| and 1% of the tree's (the floor holds the leaves at rounding
    level, such as the gradient of a conv bias ahead of a train-mode BN,
    whose exact value is 0; tests/test_torch_training.py's rule)."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-2 * top)
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=rel * scale, err_msg=n)


@pytest.mark.parametrize("kind", ["nat", "adv"])
def test_dp_train_step_matches_one_process(two_ranks, one_process, kind):
    want = one_process["train"][kind]
    for rank in two_ranks:
        got = rank["train"][kind]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        for acc in ("acc", "acc_adv", "acc_nor"):
            if acc in want:
                assert got[acc] == want[acc], acc
        _leaves_close(got["params"], want["params"], 1e-5)
        for n, v in want["state"].items():
            np.testing.assert_allclose(got["state"][n], v, rtol=0,
                                       atol=1e-6, err_msg=n)


@pytest.mark.parametrize("kind", ["nat", "adv"])
def test_dp_train_step_matches_jax_sharded(world, two_ranks, kind):
    """The loss and accuracies of JAX's sharded step on 8 virtual devices,
    at its own bars: rtol 1e-5, accuracies exact."""
    want = world["jax"][kind]
    for rank in two_ranks:
        got = rank["train"][kind]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for acc in ("acc", "acc_adv", "acc_nor"):
            if acc in want:
                assert got[acc] == want[acc], acc


def test_dp_gradient_takes_global_batch_statistics(two_ranks, one_process):
    """The train-mode gradient without augmentation: the global batch's
    (BN over all 8 waves), on each rank, against the one-process one."""
    want = one_process["train"]["grad"]
    for rank in two_ranks:
        got = rank["train"]["grad"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        _leaves_close(got["grads"], want["grads"], 1e-5)


def test_dp_adam_ranks_agree_bit_for_bit(two_ranks, one_process):
    """Adam on two ranks: the parameters and first moments are the same on
    both ranks, bit for bit, and near the one-process step's."""
    r0, r1 = (r["train"]["adam"] for r in two_ranks)
    assert r0["count"] == r1["count"] == 1
    for tree in ("params", "mu"):
        for n in r0[tree]:
            assert np.array_equal(r0[tree][n], r1[tree][n]), (tree, n)
    # Adam's first step is about -lr sign(g): a gradient at rounding level
    # may flip its sign, so the step is held within 2 lr
    want = one_process["train"]["adam"]["params"]
    for n, v in want.items():
        assert np.abs(r0["params"][n] - v).max() <= 2e-3 + 1e-6, n


def test_replicate_broadcasts_rank0(two_ranks, one_process):
    """Rank 1 starts from other weights; after ``replicate`` both hold rank
    0's, the one-process start."""
    want = one_process["train"]["params0"]
    for rank in two_ranks:
        for n, v in want.items():
            assert np.array_equal(rank["train"]["params0"][n], v), n


@pytest.mark.parametrize("case", ATTACKS)
def test_mesh_attack_matches_one_process(two_ranks, one_process, case):
    adv1, s1, extra1 = one_process["attacks"][case]
    for rank in two_ranks:
        adv2, s2, extra2 = rank["attacks"][case]
        assert s2 == s1
        assert adv2.shape == adv1.shape
        assert extra2.keys() == extra1.keys()
        for k in extra1:
            np.testing.assert_array_equal(extra2[k], extra1[k], err_msg=k)
        if case in ULP_CASES:
            # ULP-level score differences, and sign() turns an isolated
            # flip into +-step
            frac = np.mean(np.abs(adv1 - adv2) > 1e-6)
            assert frac < 1e-3, frac
            assert np.abs(adv1 - adv2).max() <= 2 * 0.004 + 1e-6
        else:
            np.testing.assert_allclose(adv2, adv1, rtol=0, atol=1e-6)


def test_shared_topk_is_all_reduced(two_ranks, one_process):
    """Each rank sees half of the batch; the max over utterances is
    all-reduced, so both freeze the one-process selection."""
    want = one_process["attacks"]["topk_sel"]
    assert want.shape == (24,)
    for rank in two_ranks:
        assert sorted(rank["attacks"]["topk_sel"]) == sorted(want)


def test_host_sharded_batches_equal_jax_global_batches(world, two_ranks):
    """The two ranks' rows of each shuffled global batch of 8 (crops of
    4,000 of 6,000-sample waves) put together, by the scipy and the native
    loaders, equal JAX's Dataset.batches and JAX's one-process
    host_sharded_batches for the same seed."""
    root, name, spks = world["dataset"]
    want = list(JaxDataset(spks, root, name, normalize=True,
                           wav_length=4000, seed=3).batches(
        8, shuffle=True, use_native=False))
    mesh = jax_make_mesh(8, axes=("data",))
    jax_hsb = list(jax_host_sharded_batches(
        JaxDataset(spks, root, name, normalize=True, wav_length=4000,
                   seed=3), 8, mesh, shuffle=True, use_native=False))
    assert len(want) == len(jax_hsb) == 2
    for use_native in (False, True):
        r0, r1 = (r["batches"][use_native] for r in two_ranks)
        assert len(r0) == len(r1) == 2
        for (w0, l0), (w1, l1), (ww, wl), (jw, jl) in zip(r0, r1, want,
                                                          jax_hsb):
            assert w0.shape == (4, 1, 4000)
            np.testing.assert_array_equal(np.concatenate([w0, w1]), ww)
            np.testing.assert_array_equal(np.concatenate([l0, l1]), wl)
            np.testing.assert_array_equal(np.concatenate([w0, w1]),
                                          np.asarray(jw))
            np.testing.assert_array_equal(np.concatenate([l0, l1]),
                                          np.asarray(jl))


def test_rank_checks_match_one_process(two_ranks, one_process):
    """parallel/rank_checks.py, which chip_smoke.py's dp_one_card spawns on
    the card, at a CPU size: the DP step on two ranks, in float32 and in
    float64, at the train steps' bars, and sharded PGD-2 on iv with the
    shared top-K: the same success list and selection, and on each rank as
    many plain Cholesky calls as the one-process run makes (the iterations
    and the final evaluation)."""
    step1, step1_64, pgd1 = one_process["rank_checks"]
    assert pgd1["topk_sel"] is not None and len(pgd1["topk_sel"]) == 24
    assert pgd1["plain_calls"]["cholesky_rt"] == 3
    for rank in two_ranks:
        step2, step2_64, pgd2 = rank["rank_checks"]
        for got, want in ((step2, step1), (step2_64, step1_64)):
            assert got["world"] == 2
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
            assert got["acc"] == want["acc"]
            _leaves_close(got["params"], want["params"], 1e-5)
            for n, v in want["state"].items():
                np.testing.assert_allclose(got["state"][n], v, rtol=0,
                                           atol=1e-6, err_msg=n)
        assert pgd2["success"] == pgd1["success"]
        assert pgd2["topk_sel"] == pgd1["topk_sel"]
        assert pgd2["plain_calls"] == pgd1["plain_calls"]
        assert pgd2["finite"] and pgd2["max_dist"] <= 0.002 + 1e-6


@pytest.fixture(scope="module")
def four_ranks(world):
    return _spawn(W.mesh_grads, 4, world["data"])


def test_sharded_attack_grad_matches_one_process(world, four_ranks):
    """2 x 2 (data, eot) mesh, 4 EOT repeats: each rank's rows (rank r is
    data index r // 2) of the one-process EOT mean.  The toy model is
    deterministic, so the mean is also the one-repeat gradient."""
    want = W.mesh_grads(world["data"])
    for r, got in enumerate(four_ranks):
        rows = slice(4 * (r // 2), 4 * (r // 2) + 4)
        np.testing.assert_allclose(got["eot_loss"], want["eot_loss"][rows],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["eot_grad"], want["eot_grad"][rows],
                                   rtol=1e-4, atol=1e-6)


def test_sharded_nes_grad_matches_one_process(world, four_ranks):
    """The antithetic pairs over 'eot', the batch over 'data': each rank's
    rows of the one-process estimate, at JAX's bars."""
    want = W.mesh_grads(world["data"])["nes"]
    for r, got in enumerate(four_ranks):
        rows = slice(4 * (r // 2), 4 * (r // 2) + 4)
        for name, v in want.items():
            np.testing.assert_allclose(got["nes"][name], v[rows], rtol=1e-3,
                                       atol=1e-4, err_msg=name)


def test_prefetch_preserves_sequence_and_errors():
    """prefetch yields the same sequence and raises the producer's error
    again at the consumer."""
    items = [np.full(3, i) for i in range(5)]
    got = list(prefetch(iter(items), size=2))
    assert all(np.array_equal(g, w) for g, w in zip(got, items))
    assert len(got) == 5

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = prefetch(boom(), size=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)


def test_train_batches_land_on_the_ranks_card(world, monkeypatch):
    """The current CUDA card is per thread, and a rank sets its own in its
    main thread only.  The training CLIs resolve an indexed device there
    (``rank_device``) and copy every batch to it in that thread, not in
    prefetch's.  Simulated on the CPU: the current card reads 1 in this
    thread and 0 in any other, and ``Tensor.to`` records the card each
    copy lands on (a bare ``cuda`` resolved in the calling thread) and
    keeps the tensor on the host."""
    import threading
    import types
    from speakerguard_tpu_torch.cli.natural_train import train_batches
    from speakerguard_tpu_torch.data.dataset import Dataset
    from speakerguard_tpu_torch.parallel.mesh import rank_device
    main = threading.get_ident()
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: 1 if threading.get_ident() == main else 0)
    landed = []
    host_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        dev = kwargs.get("device", args[0] if args else None)
        if isinstance(dev, (str, torch.device)) and \
                torch.device(dev).type == "cuda":
            dev = torch.device(dev)
            landed.append(torch.cuda.current_device() if dev.index is None
                          else dev.index)
            return self
        return host_to(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "to", to)

    assert rank_device("cuda") == torch.device("cuda", 1)
    assert rank_device("cuda:3") == torch.device("cuda", 3)
    assert rank_device("cpu") == torch.device("cpu")
    root, name, spks = world["dataset"]
    ds = Dataset(spks, root, name, normalize=True, wav_length=4000, seed=3)
    args = types.SimpleNamespace(batch_size=8, n_devices=1)
    got = list(train_batches(ds, args, None, rank_device("cuda")))
    assert len(got) == 2 and [w.shape for w, _ in got] == [(8, 4000)] * 2
    assert landed == [1] * 4


def test_batch_shard_rows_and_draws():
    """A shard's rows of a global draw, for the folds the attacks use
    (without a process group: BatchShard built by hand)."""
    g = torch.arange(2 * 6 * 3).reshape(12, 3)
    shard = BatchShard(None, 1, 3, 6, 2, 4)   # rows 2..3 of 6
    # one row per wave
    got = shard.draw_rows(lambda shape: g[:6], (2, 3))
    assert torch.equal(got, g[2:4])
    # two samples folded sample-major (NES): rows s * 6 + r
    got = shard.draw_rows(lambda shape: g, (4, 3), major="sample")
    assert torch.equal(got, torch.cat([g[2:4], g[8:10]]))
    # two entries per wave, batch-major (Siren's particles): r * 2 + s
    got = shard.draw_rows(lambda shape: g, (4, 3), major="batch")
    assert torch.equal(got, g[4:8])
    # along dim 1 (FAKEBOB's (S/2, B, L) noise)
    g3 = torch.arange(2 * 6).reshape(2, 6)
    assert torch.equal(shard.draw_rows(lambda shape: g3, (2, 2), dim=1),
                       g3[:, 2:4])
    # BatchShard.of on a 2-way axis: rows [3, 6) of 6; 5 rows do not split
    assert BatchShard.of(_TwoWayAxis(), 6)[1:] == (1, 2, 6, 3, 6)
    with pytest.raises(ValueError, match="divide"):
        BatchShard.of(_TwoWayAxis(), 5)


class _TwoWayAxis:
    """Index 1 of a 2-way mesh axis, without a process group."""

    def __getitem__(self, axis):
        return self

    def get_group(self):
        return None

    def get_local_rank(self):
        return 1

    def size(self):
        return 2
