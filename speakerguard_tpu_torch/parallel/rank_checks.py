"""Data-parallel runs that check the collective code path on the card.

Each function runs on one rank of a group started by ``parallel.mesh.
spawn`` (or in a process with no group: the one-process reference) and
returns host values only, so that the parent can compare the ranks with
the one-process run.  ``chip_smoke.py``'s ``dp_one_card`` phase spawns two
ranks of them on one card with gloo, and one under nccl; the CPU tests run
them at a small size.

- ``dp_natural_step``: one natural train step (SGD 0.1, augmentation on,
  the draws from a generator seeded alike on every rank) of AudioNet on a
  global batch from a numpy seed, data-parallel when a group exists, in
  float32 or in float64 (the waves, the log-mel and the network; the
  parameters stay float32); optionally traced with
  ``utils.profiling.trace``.  In float32 a rank's rounding differs from
  the one-process run's enough to flip the larger of a near-tied pair in
  a max-pool window at the smoke's size; in float64 it does not, so every
  parameter can be held to the same bar.
- ``sharded_pgd_iv``: PGD on iv-PLDA with ``mesh=`` (each rank attacks its
  rows; the shared top-K selection is all-reduced), with each kernel
  wrapper's launch count read around the attack on this rank.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from speakerguard_tpu_torch.models.base import tree_leaves
from speakerguard_tpu_torch.parallel.mesh import rank_device


def _mesh(device):
    from speakerguard_tpu_torch.parallel.mesh import make_mesh
    if not dist.is_initialized():
        return None
    return make_mesh(axes=("data",), device_type=torch.device(device).type)


def _host(tree):
    return {n: t.detach().float().cpu().numpy() for n, t in tree_leaves(tree)}


def dp_natural_step(device, num_class, batch, length, seed=0,
                    profile_dir=None, f64=False):
    """One natural SGD step on the global batch (``batch`` x ``length``
    waves, labels in ``num_class``), this rank's rows of it under a group;
    ``f64`` computes it in float64.  Returns the loss, the accuracy, the
    updated parameters and BN state, the step's wall seconds (after one
    warm-up step) and the world size."""
    import time
    from speakerguard_tpu_torch.models import training as T
    from speakerguard_tpu_torch.models.audionet import init_audionet
    from speakerguard_tpu_torch.optim import SGD
    from speakerguard_tpu_torch.parallel.mesh import (replicate,
                                                      shard_batch,
                                                      sharded_train_step)
    from speakerguard_tpu_torch.utils.profiling import trace
    dev = rank_device(device)
    mesh = _mesh(dev)
    rng = np.random.default_rng(seed)
    params, state = init_audionet(rng, num_class, device=dev)
    wavs = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device=dev,
        dtype=torch.float64 if f64 else torch.float32)
    labels = torch.tensor(rng.integers(0, num_class, batch), device=dev)
    sgd = SGD(0.1)
    step = T.make_natural_train_step(
        sgd, aug_eps=0.002, compute_dtype=torch.float64 if f64 else None)
    if mesh is not None:
        params, state = replicate((params, state), mesh)
        step = sharded_train_step(step, mesh)
        wavs, labels = shard_batch(wavs, mesh), shard_batch(labels, mesh)

    def run():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = step(params, state, (), wavs, labels, rng=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    run()   # warm-up: autotuning, first-use costs
    t0 = time.perf_counter()
    p, s, _, loss, acc = run()
    seconds = time.perf_counter() - t0
    rank = dist.get_rank() if dist.is_initialized() else 0
    if profile_dir:   # every rank steps (the collectives), rank 0 traces
        with trace(profile_dir) if rank == 0 else contextlib.nullcontext():
            run()
    return {"loss": float(loss), "acc": float(acc), "params": _host(p),
            "state": _host(s), "seconds": seconds,
            "world": dist.get_world_size() if dist.is_initialized() else 1}


def sharded_pgd_iv(device, batch, length, dims, iters, fast, seed=0):
    """PGD-``iters`` (eps 0.002, step 0.0004, Entropy, generator seed 0) on
    iv-PLDA of ``dims`` = (C, D, IV, R) with weights from numpy ``seed``, 10
    speakers enrolled, the clean exact decisions as labels, ``fast`` the
    model's FastPath; ``mesh=`` under a group.  Returns the success list,
    the adversarial audio's largest distance from the clean waves, each
    wrapper's launches and plain calls during the attack on this rank,
    and the shared top-K selection this rank froze."""
    from speakerguard_tpu_torch.attacks import PGD
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    from speakerguard_tpu_torch.ops import chol, gmm_loglike, gmm_stats
    from speakerguard_tpu_torch.parallel.mesh import BatchShard
    dev = rank_device(device)
    mesh = _mesh(dev)
    c, d, iv, r = dims
    params = random_iv_plda_params(np.random.default_rng(seed), c, d, iv, r,
                                   device=dev)
    model = IvPlda(params, fast=fast)
    rng = np.random.default_rng(seed + 1)
    enroll_wavs = torch.tensor(rng.uniform(-0.3, 0.3, (10, length)).astype(
        np.float32), device=dev)
    model.set_enrollment([f"spk{i}" for i in range(10)],
                         np.zeros((10, r), np.float32))
    with torch.no_grad():
        model.set_enrollment(model.spk_ids, model.embedding(enroll_wavs))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device=dev)
    with torch.no_grad():
        labels = model.make_decision(x)[0].long()
    wrappers = {"cholesky_rt": chol.cholesky_rt,
                "cholesky_rt_dinv": chol.cholesky_rt_dinv,
                "chol_solve": chol.chol_solve,
                "fused_loglike": gmm_loglike.fused_loglike,
                "stats_fwd": gmm_stats.stats_fwd,
                "stats_bwd": gmm_stats.stats_bwd}
    for w in wrappers.values():
        w.reset_counts()
    atk = PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
              max_iter=iters, loss="Entropy", mesh=mesh)
    adver, success = atk.attack(x, labels, rng=0)
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    shard = None if mesh is None else BatchShard.of(mesh, batch)
    rows = x if shard is None else shard.local(x)
    ctx = model.fast_context(rows, shard=shard)
    return {"success": [bool(s) for s in success],
            "max_dist": float((adver - x).abs().max()),
            "finite": bool(torch.isfinite(adver).all()),
            "launches": launches, "plain_calls": plain,
            "topk_sel": None if ctx is None
            else sorted(ctx.gmm.sel.tolist()),
            "world": dist.get_world_size() if dist.is_initialized() else 1}


def dp_one_card(step_args, pgd_args, profile_dir=None):
    """The checks on one rank, in one spawn: (float32 step, float64 step,
    PGD) results."""
    return (dp_natural_step(*step_args, profile_dir=profile_dir),
            dp_natural_step(*step_args, f64=True),
            sharded_pgd_iv(*pgd_args))
