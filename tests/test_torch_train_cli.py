"""The port's training CLIs (speakerguard_tpu_torch/cli/natural_train.py,
adver_train.py) against the JAX package's, on one small world.

The world: tests/fixtures.py's waves under Spk251_train and Spk251_test,
4 speakers x 2 waves of 4,400 samples each, cropped to 4,000 for
training: two batches of 4 an epoch, two epochs, augmentation on, Adam,
the pickle backend, adver with the CLI's PGD (eps 0.002, step 0.0004)
for 2 iterations and ``-evaluate_adver`` (one validation batch of 8 x
32,000). Both CLIs run in this process, the port's with ``-device cpu``.
JAX's ``main`` runs inside ``jax.disable_jit()``: jitted on the CPU, its
train-mode gradient is wrong (tests/test_torch_training.py
``test_jax_jit_train_gradient_fault``). JAX's step draws (its per-batch
``split`` of ``PRNGKey(seed)``) go to the port through ``main(args,
draws=)``. Every batch has one shape, so JAX's eager ops compile once.

The learning rate is 1e-5. Adam's first step moves every parameter by
about lr sign(g), and a gradient at rounding level (a few conv weights
of this world, besides the conv biases ahead of a train-mode BN, which
the loss does not see) takes either sign in the two packages; at lr 1e-3
those elements differ by 2e-3 after one step and the losses by 2.6%
after four (measured), at 1e-5 the flips stay below the bars. The one-
step arithmetic at lr 3e-3 is pinned in tests/test_torch_training.py.

Bars: the batch order and labels equal; each step's loss rtol 1e-5, and
2e-3 with the attack (a gradient near 0 whose sign flips moves a sample
by two PGD steps, tests/test_torch_training.py; measured 8.6e-4 at the
third step); the accuracies and the per-epoch lines of the log equal;
every checkpoint's epoch and Adam count equal; the parameters within 2
lr per step taken of JAX's and 99% of them within 0.1 lr (measured 0.3%
beyond: mostly the conv biases, whose gradient is at rounding level);
the BN state atol 1e-5 and Adam's moments within 1e-2 of their leaf's
scale, the larger of its largest entry and 1% of its tree's (the
rounding-level flips move later gradients: measured 1.4e-3 on conv1_w);
with the attack, once its sign flips have entered the trajectory (the
checkpoints after the third step), the two runs fork (the loss at the
third step differs by 8.6e-4, and the first moments of some leaves by up
to half their scale): the later checkpoints are held to the epoch, the
count, every parameter within 2 lr per step, 70% of them within 0.1 lr
and the BN state atol 1e-3 (measured 15% of the parameters beyond 0.1 lr
and 1.3e-4 in the last block's running means); validation accuracies
equal. JAX's ``load_checkpoint`` reads the port's pickles unchanged; a
resume from one continues as JAX's resume does, at the same bars.
``-ckpt_backend dcp`` writes directories whose contents equal the
pickles' and resumes to the same run; ``orbax`` raises. A port-only
adversarial run with a ragged tail whose step has no adversarial row
(acc_adv nan) shows the epoch mean skipping it, and natural_train on two
CPU ranks (gloo) equals one process (its own test's bars).
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.cli import adver_train as jax_at
from speakerguard_tpu.cli import natural_train as jax_nt
from speakerguard_tpu.models.training import \
    load_checkpoint as jax_load_checkpoint

from speakerguard_tpu_torch.cli import adver_train, natural_train
from speakerguard_tpu_torch.models.audionet import to_jax_layout
from speakerguard_tpu_torch.models.base import tree_leaves
from speakerguard_tpu_torch.models.training import (DcpCheckpointer,
                                                    load_checkpoint)
from speakerguard_tpu_torch.models.audionet import init_audionet
from speakerguard_tpu_torch.optim import Adam

from fixtures import make_wav_dataset
from test_torch_kenan import one_cpu_thread  # noqa: F401

LR = 1e-5
COMMON = ["-num_epoches", "2", "-batch_size", "4", "-wav_length", "4000",
          "-lr", str(LR), "-seed", "5"]


def _quiet(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train_cli"))
    rng = np.random.default_rng(3)
    for name in ("Spk251_train", "Spk251_test"):
        make_wav_dataset(tmp, rng, name=name, n_spks=4, utts_per_spk=2,
                         length=4400)
    return tmp


class JaxDraws:
    """JAX's CLI key schedule: ``key, sub = split(key)`` per batch from
    ``PRNGKey(seed)``; the natural step splits ``sub`` in two (a, noise),
    the adversarial one in three (attack, a, noise)."""

    def __init__(self, seed, adver):
        self.key = jax.random.PRNGKey(seed)
        self.adver = adver
        self.subs = []

    def __call__(self, step):
        while len(self.subs) <= step:
            self.key, sub = jax.random.split(self.key)
            self.subs.append(sub)
        keys = jax.random.split(self.subs[step], 3 if self.adver else 2)
        k1, k2 = keys[-2:]

        def draw(kind, shape):
            if kind == "aug_scale":
                return torch.tensor(np.asarray(jax.random.uniform(k1, ())))
            return torch.tensor(np.asarray(
                jax.random.uniform(k2, shape, jnp.float32)))
        return draw


def _record_jax(monkeypatch, module, factory):
    """Wrap ``module.<factory>`` so that each step's labels and outputs are
    recorded."""
    record = []
    orig = getattr(module, factory)

    def make(*a, **kw):
        step = orig(*a, **kw)

        def rec(params, state, opt_state, wavs, labels, rng):
            out = step(params, state, opt_state, wavs, labels, rng)
            record.append((np.asarray(labels).tolist(),
                           [float(v) for v in out[3:]]))
            return out
        return rec
    monkeypatch.setattr(module, factory, make)
    return record


def _args(module, root, tag, kind, extra):
    base = os.path.join(root, f"{kind}_{tag}")
    return module.parse_args(
        ["-root", root, "-label_encoder", os.path.join(root, f"le_{tag}.txt"),
         "-model_ckpt", base] + COMMON + extra
        + (["-device", "cpu"] if tag == "port" else [])), base


def _run_both(root, kind, extra, monkeypatch):
    """Both CLIs on the world: {package: (record, output, ckpt base)}; the
    port's record is its ``run`` result."""
    jmod, pmod, factory = {
        "natural": (jax_nt, natural_train, "make_natural_train_step"),
        "adver": (jax_at, adver_train, "make_adver_train_step")}[kind]
    args, jbase = _args(jmod, root, "jax", kind, extra)
    record = _record_jax(monkeypatch, jmod, factory)
    with jax.disable_jit():
        _, jtext = _quiet(jmod.main, args)
    args, pbase = _args(pmod, root, "port", kind, extra)
    result, ptext = _quiet(pmod.main, args,
                           draws=JaxDraws(args.seed, kind == "adver"))
    return {"jax": (record, jtext, jbase), "port": (result, ptext, pbase)}


@pytest.fixture(scope="module")
def natural(root):
    with pytest.MonkeyPatch.context() as mp:
        return _run_both(root, "natural", [], mp)


@pytest.fixture(scope="module")
def adver(root, natural):
    # JAX's adver CLI reads the label encoder the natural runs wrote
    with pytest.MonkeyPatch.context() as mp:
        return _run_both(root, "adver", ["-max_iter", "2",
                                         "-evaluate_adver"], mp)


def _np_tree(tree):
    return {n: np.asarray(v) for n, v in tree_leaves(tree)}


def _assert_ckpt_close(port_path, jax_path, steps, moment_tol=1e-2,
                       state_tol=1e-5, far_share=1e-2):
    """A port checkpoint against JAX's, both read by JAX's loader: the epoch
    and Adam's count equal; every parameter within 2 lr per step taken
    (a flipped sign moves one by 2 lr a step) and 99% of them within
    0.1 lr (the conv biases ahead of a train-mode BN, 0.4% of the
    parameters, have rounding-level gradients and flip freely); the BN
    state within ``state_tol``; Adam's moments within ``moment_tol``
    of each leaf's scale, the larger of its largest entry and 1% of
    its tree's (the floor holds the leaves at rounding level: the conv
    biases ahead of a train-mode BN). Returns the share of parameters
    beyond 0.1 lr."""
    jp, js, jo, je = jax_load_checkpoint(jax_path)
    pp, ps, po, pe = jax_load_checkpoint(port_path)
    assert pe == je
    assert int(po[0].count) == int(jo[0].count) == steps
    got_p = _np_tree(jax.tree.map(np.asarray, pp))
    far = total = 0
    for n, v in _np_tree(jax.tree.map(np.asarray, jp)).items():
        diff = np.abs(got_p[n] - v)
        assert diff.max() <= 2 * LR * steps, n
        far += int((diff > 0.1 * LR).sum())
        total += diff.size
    assert far <= far_share * total, far
    for n, v in _np_tree(jax.tree.map(np.asarray, js)).items():
        np.testing.assert_allclose(
            _np_tree(jax.tree.map(np.asarray, ps))[n], v, atol=state_tol,
            err_msg=n)
    for moment in ("mu", "nu") if moment_tol else ():
        want = _np_tree(jax.tree.map(np.asarray, getattr(jo[0], moment)))
        got = _np_tree(jax.tree.map(np.asarray, getattr(po[0], moment)))
        top = max(np.abs(v).max() for v in want.values())
        for n, v in want.items():
            scale = max(np.abs(v).max(), 1e-2 * top)
            assert np.abs(got[n] - v).max() <= moment_tol * scale, \
                (moment, n)
    return far / total


def _log(base):
    with open(base + ".log") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("kind", ["natural", "adver"])
def test_train_cli_batches_losses_and_log_match_jax(natural, adver, kind):
    runs = {"natural": natural, "adver": adver}[kind]
    jrec, jtext, jbase = runs["jax"]
    pres, ptext, pbase = runs["port"]
    assert [lab for lab, _ in jrec] == pres["labels"]
    assert [len(lab) for lab in pres["labels"]] == [4, 4] * 2
    np.testing.assert_allclose(pres["losses"], [o[0] for _, o in jrec],
                               rtol=1e-5 if kind == "natural" else 2e-3)
    if kind == "natural":
        assert pres["accs"] == [o[1] for _, o in jrec]
    else:
        assert pres["accs_adv"] == [o[1] for _, o in jrec]
        assert pres["accs_nor"] == [o[2] for _, o in jrec]
        assert len(pres["val_adver_accs"]) == 2
    assert _log(pbase) == _log(jbase)
    epochs = re.findall(r"EPOCH \d+: .*", ptext)
    assert epochs == re.findall(r"EPOCH \d+: .*", jtext)
    assert len(epochs) == 2
    vals = re.findall(r"Val .*", ptext)
    assert vals == re.findall(r"Val .*", jtext) and len(vals) == 2


@pytest.mark.parametrize("kind", ["natural", "adver"])
def test_train_cli_checkpoints_match_jax(natural, adver, kind):
    """Each epoch's checkpoint and the final one, all read by JAX's
    load_checkpoint.  With the attack, the trajectories fork once its sign
    flips enter them (the third step): the later checkpoints are held to
    the looser bars, their moments to none."""
    runs = {"natural": natural, "adver": adver}[kind]
    jbase, pbase = runs["jax"][2], runs["port"][2]
    for suffix, steps in (("_0", 2), ("_1", 4), ("", 4)):
        loose = kind == "adver" and steps > 2
        far = _assert_ckpt_close(pbase + suffix, jbase + suffix, steps,
                                 moment_tol=None if loose else 1e-2,
                                 state_tol=1e-3 if loose else 1e-5,
                                 far_share=0.3 if loose else 1e-2)
        print(f"{kind}{suffix}: {far:.2e} of the parameters beyond 0.1 lr")
    assert jax_load_checkpoint(pbase)[3] == 2


def test_train_cli_writes_the_label_encoder_as_jax(root, natural):
    with open(os.path.join(root, "le_port.txt")) as f:
        got = f.read()
    with open(os.path.join(root, "le_jax.txt")) as f:
        assert got == f.read()


def test_resume_from_port_pickle_continues_as_jax(root, natural,
                                                  monkeypatch):
    """Both CLIs resume one epoch from the port's final pickle with
    -start_epoch 2: the same losses, log and final checkpoint (epoch 3,
    Adam's count 6)."""
    extra = ["-ori_model_ckpt", natural["port"][2], "-start_epoch", "2",
             "-num_epoches", "1", "-evaluate_per_epoch", "0"]
    jmod = jax_nt
    args, jbase = _args(jmod, root, "jax", "resume", extra)
    record = _record_jax(monkeypatch, jmod, "make_natural_train_step")
    with jax.disable_jit():
        _quiet(jmod.main, args)
    args, pbase = _args(natural_train, root, "port", "resume", extra)
    result, _ = _quiet(natural_train.main, args,
                       draws=JaxDraws(args.seed, False))
    np.testing.assert_allclose(result["losses"], [o[0] for _, o in record],
                               rtol=1e-5)
    assert _log(pbase) == _log(jbase)
    assert _log(pbase)[0].startswith("EPOCH 2/3")
    _assert_ckpt_close(pbase, jbase, 6)


def test_dcp_backend_round_trips_and_resumes(root, natural):
    """The same one-epoch run with the pickle and the dcp backend: the dcp
    directories hold what the pickles hold, and a resume from either is
    the same run; -ckpt_backend orbax raises."""
    runs = {}
    for backend in ("pickle", "dcp"):
        extra = ["-num_epoches", "1", "-evaluate_per_epoch", "0",
                 "-ckpt_backend", backend]
        args, base = _args(natural_train, root, "port", f"ck_{backend}",
                           extra)
        first, _ = _quiet(natural_train.main, args)
        args, rbase = _args(natural_train, root, "port", f"re_{backend}",
                            extra + ["-ori_model_ckpt", base + "_0",
                                     "-start_epoch", "1"])
        second, _ = _quiet(natural_train.main, args)
        runs[backend] = (first, second, base, rbase)
    assert os.path.isdir(runs["dcp"][2] + "_0")
    assert runs["dcp"][0]["losses"] == runs["pickle"][0]["losses"]
    assert runs["dcp"][1]["losses"] == runs["pickle"][1]["losses"]
    template = init_audionet(np.random.default_rng(0), 4, device="cpu")
    for base_i in (2, 3):
        want = load_checkpoint(runs["pickle"][base_i], device="cpu")
        got = DcpCheckpointer().load(runs["dcp"][base_i], *template,
                                     Adam(LR).init(template[0]))
        assert got[3] == want[3] and got[2].count == want[2].count
        for g, w in ((got[0], want[0]), (got[1], want[1]),
                     (got[2].mu, want[2].mu), (got[2].nu, want[2].nu)):
            for (n, a), (_, b) in zip(tree_leaves(g), tree_leaves(w)):
                assert np.array_equal(a.numpy(), b.numpy()), n
    args, _ = _args(natural_train, root, "port", "orbax",
                    ["-ckpt_backend", "orbax"])
    with pytest.raises(ValueError, match="dcp"):
        natural_train.main(args)
    # and the port's pickle reads back into JAX's layouts unchanged
    params, state, _, _ = load_checkpoint(natural["port"][2], device="cpu")
    jp, js, _, _ = jax_load_checkpoint(natural["port"][2])
    for n, v in _np_tree(to_jax_layout(params, state)[0]).items():
        assert np.array_equal(_np_tree(jax.tree.map(np.asarray, jp))[n], v)


def test_adver_epoch_mean_skips_a_ragged_tail_without_adversarial_rows(
        root, natural):
    """Batches of 3 at ratio 0.4 end on a batch of 2, whose step attacks
    int(0.8) = 0 rows: its acc_adv is nan, and the epoch's mean, printed and
    logged, is the nanmean of the others."""
    args, base = _args(adver_train, root, "port", "ragged", [
        "-batch_size", "3", "-ratio", "0.4", "-num_epoches", "1",
        "-evaluate_per_epoch", "0", "-max_iter", "1"])
    result, text = _quiet(adver_train.main, args)
    assert [len(lab) for lab in result["labels"]] == [3, 3, 2]
    accs = result["accs_adv"]
    assert np.isnan(accs[2]) and not np.isnan(accs[:2]).any()
    assert result["epoch_accs"][0][0] == float(np.mean(accs[:2]))
    assert f"Acc adv = {np.mean(accs[:2]):.4f}" in text
    assert "nan" not in _log(base)[0]


def test_natural_train_two_ranks_equal_one(root):
    """natural_train -n_devices 2 on the CPU (two spawned ranks under gloo,
    each loading its rows of every global batch of 4), one epoch, against
    one process,
    both writing dcp directories: the same accuracies and log, the losses
    rtol 1e-5, and the final checkpoints at this file's bars (the
    parameters within 2 lr per step and 99% of them within 0.1 lr, the BN
    state atol 1e-5): the all-reduces reorder the sums, and Adam turns a
    rounding-level gradient's sign into a 2 lr step (measured 2.0e-6 on
    the losses)."""
    runs = {}
    for n in ("1", "2"):
        args, base = _args(natural_train, root, "port", f"dp{n}", [
            "-n_devices", n, "-ckpt_backend", "dcp", "-evaluate_per_epoch",
            "0", "-num_epoches", "1"])
        runs[n] = (natural_train.main(args), base)
    (r1, b1), (r2, b2) = runs["1"], runs["2"]
    assert r2["labels"] == [lab[:2] for lab in r1["labels"]]  # rank 0's rows
    np.testing.assert_allclose(r2["losses"], r1["losses"], rtol=1e-5)
    assert r2["accs"] == r1["accs"]
    assert _log(b2) == _log(b1)
    template = init_audionet(np.random.default_rng(0), 4, device="cpu")
    opt = Adam(LR).init(template[0])
    got = DcpCheckpointer().load(b2, *template, opt)
    want = DcpCheckpointer().load(b1, *template, opt)
    assert got[3] == want[3] == 1 and got[2].count == want[2].count == 2
    far = total = 0
    for (n, a), (_, b) in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2 * LR * 2, n
        far += int((diff > 0.1 * LR).sum())
        total += diff.numel()
    assert far <= 1e-2 * total, far
    for (n, a), (_, b) in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert float((a - b).abs().max()) <= 1e-5, n
