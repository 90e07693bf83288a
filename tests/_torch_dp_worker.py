"""Rank functions for tests/test_torch_parallel.py and test_torch_train_cli.py.

Each runs inside a rank spawned by ``speakerguard_tpu_torch.parallel.mesh.
spawn`` (gloo, on the CPU) and imports only the port; the parent computes
the references (the one-process port runs, through the same functions with
``mesh=None``, and JAX's) and compares.  Inputs come as .npy files; results
go back as dicts of numpy arrays and lists.
"""

import os

import numpy as np
import torch

from speakerguard_tpu_torch.models.base import SRSModel, tree_leaves

TOY_LEN = 4000


class ToyModel(SRSModel):
    """tests/test_attacks.py's ToyModel in the port: scores = the means of
    100-sample frames @ W, a dense gradient and a sharp boundary."""

    allowed_flags = (0, 1)
    range_type = "scale"
    threshold = float("-inf")

    def __init__(self, num_class=4, frame=100, length=TOY_LEN, seed=0):
        super().__init__()
        w = np.random.default_rng(seed).standard_normal(
            (length // frame, num_class)).astype(np.float32)
        self.register_buffer("w", torch.tensor(w))
        self.frame = frame
        self.spk_ids = [str(i) for i in range(num_class)]

    def _raw(self, wav, rng=None, fast=False):
        return wav.reshape(wav.shape[0], -1, self.frame)

    def _embedding_from_top(self, feats, fast=False, fast_ctx=None):
        return feats.mean(-1)

    def _scores_from_emb(self, emb, enroll_embs=None):
        return emb @ self.w


def _np(tree):
    return {n: t.detach().numpy().copy() for n, t in tree_leaves(tree)}


def _mesh(axes=("data",), shape=None):
    import torch.distributed as dist
    from speakerguard_tpu_torch.parallel.mesh import make_mesh
    if not dist.is_initialized():
        return None
    torch.set_num_threads(1)
    return make_mesh(axes=axes, shape=shape, device_type="cpu")


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _draw_fn(a, noise):
    draws = {"aug_scale": torch.tensor(a), "aug_noise": torch.tensor(noise)}

    def draw(kind, shape):
        assert tuple(draws[kind].shape) == tuple(shape), (kind, shape)
        return draws[kind]
    return draw


def train_steps(data_dir):
    """The natural (SGD, 8 waves) and adversarial (SGD, 16 waves) steps, a
    natural Adam step and the f32 train gradient without augmentation, on
    this rank's rows (all of them without a process group).  The draws are
    the global batch's, from ``data_dir``."""
    from speakerguard_tpu_torch.models import training as T
    from speakerguard_tpu_torch.models.audionet import init_audionet
    from speakerguard_tpu_torch.optim import SGD, Adam
    from speakerguard_tpu_torch.parallel.mesh import (BatchShard, replicate,
                                                      shard_batch,
                                                      sharded_train_step)
    mesh = _mesh()
    def load(name):
        return np.load(os.path.join(data_dir, name + ".npy"))
    params, state = init_audionet(np.random.default_rng(0), 4, device="cpu")
    if mesh is not None:
        # rank 1 starts from other weights: replicate must broadcast rank 0's
        if mesh.get_local_rank() == 1:
            params, state = init_audionet(np.random.default_rng(1), 4,
                                          device="cpu")
        params, state = replicate((params, state), mesh)

    def wrap(step):
        return step if mesh is None else sharded_train_step(step, mesh)

    def rows(name):
        t = torch.tensor(load(name))
        return t if mesh is None else shard_batch(t, mesh)

    out = {"params0": _np(params)}
    sgd = SGD(0.1)
    nat = wrap(T.make_natural_train_step(sgd, aug_eps=0.002))
    p, s, _, loss, acc = nat(params, state, (), rows("nat_wavs"),
                             rows("nat_labels"),
                             draw_fn=_draw_fn(load("nat_a"),
                                              load("nat_noise")))
    out["nat"] = dict(loss=float(loss), acc=float(acc), params=_np(p),
                      state=_np(s))

    attack = T.make_pgd_for_training(epsilon=0.01, step_size=0.004,
                                      max_iter=2)
    adv = wrap(T.make_adver_train_step(sgd, attack, ratio=0.5,
                                       aug_eps=0.002))
    p, s, _, loss, acc_adv, acc_nor = adv(
        params, state, (), rows("adv_wavs"), rows("adv_labels"),
        draw_fn=_draw_fn(load("adv_a"), load("adv_noise")))
    out["adv"] = dict(loss=float(loss), acc_adv=float(acc_adv),
                      acc_nor=float(acc_nor), params=_np(p), state=_np(s))

    adam = Adam(1e-3)
    nat_adam = wrap(T.make_natural_train_step(adam, aug_eps=0.002))
    p, _, o, _, _ = nat_adam(params, state, adam.init(params),
                             rows("nat_wavs"), rows("nat_labels"), rng=5)
    out["adam"] = dict(params=_np(p), mu=_np(o.mu), count=o.count)

    wavs, labels = rows("nat_wavs"), rows("nat_labels")
    sync = None
    if mesh is not None:
        shard = BatchShard.of_local(mesh, wavs.shape[0])
        sync = (shard.group, shard.n)
    loss, grads, _, _ = T.loss_and_grads(params, state, wavs, labels,
                                         sync=sync)
    out["grad"] = dict(loss=float(loss), grads=_np(grads))
    return out


# ---------------------------------------------------------------------------
# EOT and NES gradients over a (data, eot) mesh
# ---------------------------------------------------------------------------

def mesh_grads(data_dir):
    """``sharded_attack_grad`` (4 EOT repeats) and ``sharded_nes_grad`` (8
    samples) on the toy model over a 2 x 2 (data, eot) mesh; without a
    process group, ``adaptive.eot`` and ``adaptive.nes`` on the whole
    batch."""
    from speakerguard_tpu_torch.adaptive import nes
    from speakerguard_tpu_torch.adaptive.eot import eot, eot_no_grad
    from speakerguard_tpu_torch.attacks.losses import (margin_loss,
                                                       resolve_loss)
    from speakerguard_tpu_torch.parallel.mesh import (sharded_attack_grad,
                                                      sharded_nes_grad,
                                                      shard_batch)
    mesh = _mesh(("data", "eot"), (2, 2))
    model = ToyModel()
    x = torch.tensor(np.load(os.path.join(data_dir, "x.npy")))
    y = torch.tensor(np.load(os.path.join(data_dir, "y.npy")))
    noise = torch.tensor(np.load(os.path.join(data_dir, "noise.npy")))
    loss_fn, _ = resolve_loss("Margin", task="CSI")

    def nes_loss(s, lab):
        return margin_loss(s, lab, task="CSI", targeted=False,
                           clip_max=False)
    eot_fn = eot_no_grad(lambda xx, g: model.score(xx), nes_loss,
                         model.threshold)
    kw = dict(samples_per_draw=8, sigma=1e-3, num_classes=4)
    if mesh is None:
        _, loss, grad, _ = eot(lambda xx, g: model.score(xx), loss_fn,
                               model.threshold, 4)(x, y, None)
        got = nes.nes_grad(eot_fn, x, y, noise, **kw)
    else:
        xs, ys = shard_batch(x, mesh), shard_batch(y, mesh)
        loss, grad = sharded_attack_grad(
            lambda xx, g: model.score(xx), loss_fn, mesh)(xs, ys, [None] * 4)
        got = sharded_nes_grad(eot_fn, mesh, **kw)(xs, ys, noise)
    names = ("mean_loss", "grad", "adver_loss", "adver_score", "predict")
    return {"eot_loss": loss.numpy(), "eot_grad": grad.numpy(),
            "nes": {n: t.numpy() for n, t in zip(names, got)}}


# ---------------------------------------------------------------------------
# attacks under mesh=
# ---------------------------------------------------------------------------

def _iv_model(fast):
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    rng = np.random.default_rng(0)
    params = random_iv_plda_params(rng, num_gaussians=64, dim=72,
                                   ivector_dim=48, reduced_dim=16,
                                   device="cpu")
    model = IvPlda(params, fast=fast)
    model.set_enrollment(["a", "b", "c"],
                         rng.standard_normal((3, 16)).astype(np.float32))
    return model


def _xv_model():
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    rng = np.random.default_rng(1)
    model = XvPlda(random_xv_plda_params(rng, device="cpu"))
    model.set_enrollment(["a", "b", "c"],
                         rng.standard_normal((3, 150)).astype(np.float32))
    return model


def attack_cases(data_dir):
    """{case: (model builder, attack builder, waves name, labels name)}:
    the attacks of tests/test_parallel.py, the defaults the toy model
    reaches, and the dithered models' folds of samples into rows."""
    from speakerguard_tpu_torch.attacks import (CW2, FAKEBOB, FGSM, PGD,
                                                SirenAttack)
    from speakerguard_tpu_torch.models.base import FastPath
    toy = ("toy_x", "toy_y")
    pgd = dict(task="CSI", epsilon=0.002, step_size=0.0005, max_iter=4)
    iv_pgd = dict(task="CSI", epsilon=0.004, step_size=0.001, max_iter=2)
    return {
        "pgd_toy": (ToyModel, lambda m, mesh: PGD(m, mesh=mesh, **pgd), toy),
        "pgd_toy_restarts": (ToyModel, lambda m, mesh: PGD(
            m, mesh=mesh, num_random_init=3, **pgd), toy),
        "fgsm_toy": (ToyModel, lambda m, mesh: FGSM(
            m, task="CSI", epsilon=0.002, mesh=mesh), toy),
        "cw2_toy": (ToyModel, lambda m, mesh: CW2(
            m, task="CSI", max_iter=8, binary_search_steps=2,
            stop_early=True, stop_early_iter=2, initial_const=10.0,
            mesh=mesh), toy),
        "fakebob_toy": (ToyModel, lambda m, mesh: FAKEBOB(
            m, task="CSI", epsilon=0.002, max_iter=6, samples_per_draw=4,
            samples_per_draw_batch_size=4, max_lr=0.001, stop_early=False,
            mesh=mesh), toy),
        "siren_toy": (ToyModel, lambda m, mesh: SirenAttack(
            m, task="CSI", epsilon=0.002, max_epoch=2, max_iter=4,
            n_particles=5, abort_early=True, abort_early_iter=2,
            abort_early_epoch=1, mesh=mesh), toy),
        "pgd_xv": (_xv_model, lambda m, mesh: PGD(
            m, mesh=mesh, **iv_pgd), ("xv_x", "xv_y")),
        "fakebob_xv": (_xv_model, lambda m, mesh: FAKEBOB(
            m, task="CSI", epsilon=0.002, max_iter=2, samples_per_draw=4,
            samples_per_draw_batch_size=2, stop_early=False, mesh=mesh),
            ("xv_x", "xv_y")),
        "siren_xv": (_xv_model, lambda m, mesh: SirenAttack(
            m, task="CSI", epsilon=0.002, max_epoch=1, max_iter=2,
            n_particles=3, abort_early=False, mesh=mesh), ("xv_x", "xv_y")),
        "pgd_iv": (lambda: _iv_model(None), lambda m, mesh: PGD(
            m, mesh=mesh, **iv_pgd), ("iv_x", "iv_y")),
        "pgd_iv_topk": (lambda: _iv_model(FastPath(gmm_topk=24)),
                        lambda m, mesh: PGD(m, mesh=mesh, **iv_pgd),
                        ("iv_x", "iv_y")),
    }


def attacks(data_dir, names):
    """Each named case's (adversarial audio, success list[, CW2's consts,
    FAKEBOB's NES bodies, Siren's epochs]) on every rank, with the
    attack's generator seeded 7; the shared top-K selection of the iv
    fast case."""
    mesh = _mesh()
    cases = attack_cases(data_dir)
    def load(name):
        return np.load(os.path.join(data_dir, name + ".npy"))
    out = {}
    for name in names:
        build_model, build_attack, (xn, yn) = cases[name]
        model = build_model()
        atk = build_attack(model, mesh)
        adv, success = atk.attack(torch.tensor(load(xn)),
                                  torch.tensor(load(yn)), rng=7)
        extra = {}
        for attr in ("consts", "last_executed_iters",
                     "last_executed_epochs"):
            if getattr(atk, attr, None) is not None:
                extra[attr] = np.asarray(getattr(atk, attr))
        out[name] = (adv.numpy(), list(success), extra)
        if name == "pgd_iv_topk":
            from speakerguard_tpu_torch.parallel.mesh import BatchShard
            x = torch.tensor(load(xn))
            shard = None
            if mesh is not None:
                shard = BatchShard.of(mesh, x.shape[0])
                x = shard.local(x)
            out["topk_sel"] = model.fast_context(x, shard=shard).gmm.sel \
                .numpy()
    return out


# ---------------------------------------------------------------------------
# the input pipeline
# ---------------------------------------------------------------------------

def batches(root, name, spks):
    """This rank's rows of every global batch of 8 (shuffled, seed 3), by
    the scipy and the native loaders."""
    from speakerguard_tpu_torch.data.dataset import Dataset
    from speakerguard_tpu_torch.parallel.input import host_sharded_batches
    mesh = _mesh()
    out = {}
    for use_native in (False, True):
        ds = Dataset(spks, root, name, normalize=True, wav_length=4000,
                     seed=3)
        out[use_native] = list(host_sharded_batches(
            ds, 8, mesh, shuffle=True, use_native=use_native))
    return out


# parallel/rank_checks.py at a CPU size: chip_smoke.py's dp_one_card
# phase, rehearsed
RANK_CHECK_STEP = ("cpu", 4, 8, 4000)


def rank_check_pgd():
    from speakerguard_tpu_torch.models.base import FastPath
    return ("cpu", 8, 8000, (64, 72, 48, 16), 2, FastPath(gmm_topk=24))


def two_rank_jobs(data_dir, root, name, spks, attack_names):
    """Everything tests/test_torch_parallel.py runs on two ranks, in one
    spawn: the train steps, the attacks, the input pipeline and the rank
    checks of chip_smoke.py's dp_one_card."""
    from speakerguard_tpu_torch.parallel import rank_checks
    return {"train": train_steps(data_dir),
            "attacks": attacks(data_dir, attack_names),
            "batches": batches(root, name, spks),
            "rank_checks": rank_checks.dp_one_card(RANK_CHECK_STEP,
                                                   rank_check_pgd())}
