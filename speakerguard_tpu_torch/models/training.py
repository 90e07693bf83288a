"""Training for AudioNet CSI-NE: the natural and adversarial train steps,
and checkpoints that both packages read.

Port of speakerguard_tpu/models/training.py (reference natural_train.py /
adver_train.py).  A step factory returns ``step(params, state, opt_state,
wavs, labels, rng=None, draw_fn=None) -> (params, state, opt_state, loss,
acc)`` (the adversarial step returns ``acc_adv, acc_nor`` in place of
``acc``), on the port's ``AudioNetParams`` / ``AudioNetState`` and an
``optim.AdamState``.  One step is: noise augmentation -> the exact log-mel
frontend -> the CNN with BatchNorm in train mode -> mean cross entropy ->
the gradient over the parameter leaves (``torch.autograd.grad``) -> one
step of optax's Adam.  The loss and accuracies come back as 0-d device
tensors, so a step reads nothing back to the host.

- The frontend runs without autograd: the waves need no gradient, so its
  backward never runs (the adversarial step's waves get theirs only inside
  the attack).
- The new BN running stats are an auxiliary output: they are detached, so
  no step's graph outlives it and the loss gradient does not reach them.
- The train substep runs with cuDNN's autotuning on (restored after):
  without it, cuDNN's heuristics send the float32 weight gradients to FFT
  algorithms, 9x slower at the JAX bench's point.
- ``compute_dtype="bf16"``: the parameters, the BN state and the features
  are cast to bf16 inside the differentiated function (the cast's backward
  returns float32 gradients to the float32 master weights), the logits are
  cast to float32 before the cross entropy, and the new BN state, computed
  in bf16 as JAX computes it (``models/audionet.py`` ``_bn``), is cast to
  float32.  Master parameters, Adam state and BN state stay float32.
- Randomness: ``draw_fn(kind, shape)`` gives uniform [0, 1) float32 draws,
  ``"aug_scale"`` (the scalar a) and then ``"aug_noise"`` (the noise of
  the augmented waves), in that order.  By default they come from ``rng``
  (a ``torch.Generator`` on the waves' device, or an int seed); the CPU
  tests pass the draws of JAX's keys.

Data parallelism: every step takes ``shard=`` (a ``parallel.mesh.
BatchShard``, which ``parallel.mesh.sharded_train_step`` passes): the
waves and labels are then this rank's rows of the global batch, and the
step returns what the one-process step returns on the global batch.
Train-mode BN takes the global batch's statistics, the loss and
accuracies are global means, the gradients are summed over the ranks, the
adversarial rows are the first ``int(n * ratio)`` global rows (a rank may
attack all of its rows, or none), and each draw is the global batch's,
of which the rank takes its rows (``draw_fn`` gives the global draws).

Checkpoints are pickles of ``{"params", "state", "opt_state", "epoch"}``
with numpy leaves in the JAX package's layouts and its class names
(``speakerguard_tpu.models.audionet.AudioNetParams``, optax's
``ScaleByAdamState`` and ``EmptyState``), which JAX's ``load_checkpoint``
reads unchanged.  Both directions go without importing jax, optax or the
JAX package: the names are written by a pickler that emits them as text,
and read by an unpickler that maps them onto stand-ins and lets through
only numpy's array reconstruction.  JAX's orbax pair (an asynchronous
checkpoint directory) has its counterpart in ``DcpCheckpointer``, on
``torch.distributed.checkpoint``: orbax imports JAX, and the directory it
writes is not one orbax reads, so it does not carry orbax's name.  The
pickle is the format both packages share.
"""

import contextlib
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from speakerguard_tpu_torch.attacks.base import make_generator
from speakerguard_tpu_torch.models.audionet import (AudioNetParams,
                                                    AudioNetState,
                                                    audionet_logits,
                                                    from_jax_layout,
                                                    to_jax_layout)
from speakerguard_tpu_torch.models.base import (tree_leaves, tree_map,
                                                tree_rebuild)
from speakerguard_tpu_torch.ops.logmel import audionet_logmel
from speakerguard_tpu_torch.optim import Adam, AdamState
from speakerguard_tpu_torch.parallel.mesh import all_reduce_tree


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None])[:, 0]


def resolve_compute_dtype(compute_dtype):
    """'bf16' / 'f32' / None or a torch dtype -> the dtype of the network's
    compute, or None for exact float32 (the reference-parity default)."""
    if compute_dtype in (None, "f32", "float32", torch.float32):
        return None
    if compute_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    raise ValueError(f"unknown compute dtype {compute_dtype!r}")


def _cast(tree, dtype):
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def generator_draw(rng, device):
    """The default ``draw_fn``: uniform [0, 1) draws from ``rng`` (a
    torch.Generator, used as is, or an int seed; None is seed 0)."""
    gen = make_generator(rng, device)

    def draw(kind, shape):
        return torch.rand(shape, generator=gen, device=gen.device)
    return draw


def _augment(draw, clean, aug_eps, rows=None):
    """The noisy copies of ``clean``: uniform noise in [-a eps, a eps) at a
    scale a ~ U[0, 1) (reference natural_train.py:138-148).  ``rows`` =
    (n, start): ``clean`` is rows [start, start + len) of an n-row batch,
    whose noise is drawn and sliced."""
    a = draw("aug_scale", ())
    if rows is None:
        u = draw("aug_noise", tuple(clean.shape))
    else:
        n, start = rows
        u = torch.as_tensor(draw("aug_noise", (n, *clean.shape[1:])))
        u = u.narrow(0, start, clean.shape[0])
    return clean + (2.0 * a * aug_eps * u - a * aug_eps)


@contextlib.contextmanager
def _cudnn_autotune():
    """cuDNN picks each convolution's algorithm by timing them (restored
    after).  Without it, its heuristics send the float32 weight gradients
    (TF32 off) to FFT algorithms: on an H100 at the bench's point, 152 of a
    170 ms step and a 33 GB peak."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


def loss_and_grads(params, state, wavs, labels, cdt=None, sync=None):
    """(mean CE loss, gradient tree, new BN state, logits) of the forward
    in train mode on ``wavs`` in the compute dtype ``cdt`` (None: float32;
    see ``resolve_compute_dtype``): what one train step differentiates.
    The gradient is float32 and shaped like ``params``; every output is
    detached.  ``sync`` = (process group, rows of the global batch): the
    waves are this rank's rows, BN takes the global statistics, and the
    loss and the gradient are the global batch's (summed over the group);
    the logits stay this rank's."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.no_grad():
        feats = audionet_logmel(wavs)
    with torch.enable_grad(), _cudnn_autotune():
        logits, _, new_state = audionet_logits(
            _cast(leaves, cdt), _cast(state, cdt),
            feats if cdt is None else feats.to(cdt), train=True, sync=sync)
        logits = logits.to(torch.float32)
        ce = cross_entropy(logits, labels)
        loss = torch.mean(ce) if sync is None else ce.sum() / sync[1]
        names = [n for n, _ in tree_leaves(leaves)]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [t for _, t in tree_leaves(leaves)])))
    new_state = tree_map(lambda t: t.detach().to(torch.float32), new_state)
    grads = tree_rebuild(params, grads.__getitem__)
    loss = loss.detach()
    if sync is not None:
        grads = all_reduce_tree(grads, sync[0])
        loss = all_reduce_tree((loss,), sync[0])[0]
    return loss, grads, new_state, logits.detach()


def _optimizer(optimizer):
    return Adam(optimizer) if isinstance(optimizer, (int, float)) \
        else optimizer


def _accuracy(logits, labels, group=None, count=None):
    """The share of rows whose argmax is the label; with ``group``, the
    count of such rows summed over the group, over ``count`` rows."""
    hit = (torch.argmax(logits, -1) == labels).to(torch.float32)
    if group is None:
        return torch.mean(hit)
    return all_reduce_tree((hit.sum(),), group)[0] / count


def make_natural_train_step(optimizer, aug_eps: float = 0.002,
                            compute_dtype=None):
    """``optimizer``: an ``optim.Adam`` (or ``optim.SGD``) or a learning
    rate.  Returns step(params, state, opt_state, wavs (B, L) scale
    domain, labels (B,), rng=None, draw_fn=None, shard=None) -> (params,
    state, opt_state, loss, acc).  With ``aug_eps > 0`` the batch is
    [wavs; noisy wavs] and the labels are repeated; ``acc`` is over the
    doubled batch."""
    opt = _optimizer(optimizer)
    cdt = resolve_compute_dtype(compute_dtype)

    def step(params, state, opt_state, wavs, labels, rng=None,
             draw_fn=None, shard=None):
        n = wavs.shape[0] if shard is None else shard.n
        rows = None if shard is None else (shard.n, shard.start)
        if aug_eps > 0.0:
            draw = draw_fn or generator_draw(rng, wavs.device)
            wavs_all = torch.cat([wavs, _augment(draw, wavs, aug_eps,
                                                 rows)])
            labels_all = torch.cat([labels, labels])
        else:
            wavs_all, labels_all = wavs, labels
        total = n * (2 if aug_eps > 0.0 else 1)
        sync = None if shard is None else (shard.group, total)
        loss, grads, new_state, logits = loss_and_grads(
            params, state, wavs_all, labels_all, cdt, sync)
        params, opt_state = opt.update(params, grads, opt_state)
        return (params, new_state, opt_state, loss,
                _accuracy(logits, labels_all, sync and sync[0], total))

    return step


def make_adver_train_step(optimizer, attack_fory, ratio: float = 0.5,
                          aug_eps: float = 0.002, compute_dtype=None):
    """The adversarial step: the first ``int(B * ratio)`` waves are replaced
    by ``attack_fory(params, state, wavs, labels) -> adversarial wavs``,
    made against the current parameters (reference adver_train.py:190-223;
    e.g. ``make_pgd_for_training``).  With ``aug_eps > 0`` noisy copies of
    the clean remainder are appended, with its labels.  Returns (params,
    state, opt_state, loss, acc_adv, acc_nor): the accuracy on the
    adversarial waves and on the clean remainder, the noisy copies left
    out (nan over no rows).  ``compute_dtype`` sets the train substep's
    precision; the attack keeps its own.  With ``shard``, B and the
    adversarial rows are the global batch's."""
    opt = _optimizer(optimizer)
    cdt = resolve_compute_dtype(compute_dtype)

    def step(params, state, opt_state, wavs, labels, rng=None,
             draw_fn=None, shard=None):
        b = wavs.shape[0]
        n, lo = (b, 0) if shard is None else (shard.n, shard.start)
        n_adv = int(n * ratio)
        a_loc = min(max(n_adv - lo, 0), b)   # this rank's adversarial rows
        adv = (attack_fory(params, state, wavs[:a_loc], labels[:a_loc])
               if a_loc else wavs[:0])
        wavs_mixed = torch.cat([adv, wavs[a_loc:]])
        if aug_eps > 0.0:
            draw = draw_fn or generator_draw(rng, wavs.device)
            rows = None if shard is None else (n - n_adv, lo + a_loc - n_adv)
            wavs_all = torch.cat(
                [wavs_mixed, _augment(draw, wavs[a_loc:], aug_eps, rows)])
            labels_all = torch.cat([labels, labels[a_loc:]])
            total = 2 * n - n_adv
        else:
            wavs_all, labels_all, total = wavs_mixed, labels, n
        sync = None if shard is None else (shard.group, total)
        loss, grads, new_state, logits = loss_and_grads(
            params, state, wavs_all, labels_all, cdt, sync)
        params, opt_state = opt.update(params, grads, opt_state)
        group = sync and sync[0]
        return (params, new_state, opt_state, loss,
                _accuracy(logits[:a_loc], labels[:a_loc], group, n_adv),
                _accuracy(logits[a_loc:b], labels[a_loc:], group,
                          n - n_adv))

    return step


def make_pgd_for_training(epsilon=0.002, step_size=0.0004, max_iter=10):
    """PGD against the live model for the adversarial step: ``max_iter``
    signed steps on the summed cross entropy from the clean waves (no
    random start), clipped to the eps ball and [-1, 1].  The model runs as
    the JAX package's does: BatchNorm in eval mode with the current
    running stats, on the float32 parameters, the exact frontend.  FGSM is
    ``step_size=epsilon, max_iter=1``."""

    def attack(params, state, wavs, labels):
        params = tree_map(torch.Tensor.detach, params)
        lower = torch.clamp(wavs - epsilon, min=-1.0)
        upper = torch.clamp(wavs + epsilon, max=1.0)
        x = wavs.detach()
        for _ in range(max_iter):
            x = x.requires_grad_(True)
            with torch.enable_grad():
                logits, _, _ = audionet_logits(params, state,
                                               audionet_logmel(x))
                (g,) = torch.autograd.grad(
                    torch.sum(cross_entropy(logits, labels)), x)
            x = torch.clamp(x.detach() + step_size * torch.sign(g), lower,
                            upper)
        return x

    return attack


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class ScaleByAdamState(NamedTuple):
    """Stands in for optax's state of the same name in a checkpoint."""
    count: np.ndarray
    mu: AudioNetParams
    nu: AudioNetParams


class EmptyState(NamedTuple):
    """Stands in for optax's EmptyState (scale_by_learning_rate's)."""


# the stand-ins and the JAX-side names a checkpoint gives them
_JAX_NAMES = {
    AudioNetParams: ("speakerguard_tpu.models.audionet", "AudioNetParams"),
    AudioNetState: ("speakerguard_tpu.models.audionet", "AudioNetState"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    EmptyState: ("optax._src.base", "EmptyState"),
}
_STAND_INS = {name: cls for cls, name in _JAX_NAMES.items()}
# numpy's reconstruction of arrays and scalars, under numpy 2's and 1's
# module names
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    **{(m, "_reconstruct"): np.empty(0).__reduce__()[0]
       for m in ("numpy._core.multiarray", "numpy.core.multiarray")},
    **{(m, "scalar"): np.float32(0).__reduce__()[0]
       for m in ("numpy._core.multiarray", "numpy.core.multiarray")},
}


class _JaxNamesPickler(pickle._Pickler):
    """Writes each stand-in class as a GLOBAL opcode with its JAX-side
    name, so that the stream names classes this process never imports."""

    def save_global(self, obj, name=None):
        where = _JAX_NAMES.get(obj)
        if where is None:
            return super().save_global(obj, name)
        self.write(pickle.GLOBAL + f"{where[0]}\n{where[1]}\n".encode())
        self.memoize(obj)


class _JaxNamesUnpickler(pickle.Unpickler):
    """Maps the JAX-side names onto the stand-ins; lets through numpy's
    reconstruction globals and nothing else."""

    def find_class(self, module, name):
        cls = _STAND_INS.get((module, name),
                             _NUMPY_GLOBALS.get((module, name)))
        if cls is None:
            raise pickle.UnpicklingError(
                f"a checkpoint may not name {module}.{name}")
        return cls


def save_checkpoint(path, params: AudioNetParams, state: AudioNetState,
                    opt_state: AdamState | None = None, epoch: int = 0):
    """JAX's ``save_checkpoint`` blob in JAX's layouts: Adam's state is
    optax's ``(ScaleByAdamState(count, mu, nu), EmptyState())``."""
    net, bn = to_jax_layout(params, state)
    opt = None
    if opt_state is not None:
        opt = (ScaleByAdamState(np.asarray(opt_state.count, np.int32),
                                to_jax_layout(opt_state.mu, None)[0],
                                to_jax_layout(opt_state.nu, None)[0]),
               EmptyState())
    blob = {"params": net, "state": bn, "opt_state": opt, "epoch": epoch}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        _JaxNamesPickler(f, protocol=4).dump(blob)


def load_checkpoint(path, device=None):
    """(params, state, opt_state or None, epoch) on ``device`` from a
    checkpoint written by either package."""
    with open(path, "rb") as f:
        blob = _JaxNamesUnpickler(f).load()
    params, state = from_jax_layout(blob["params"], blob["state"], device)
    opt_state = None
    if blob["opt_state"] is not None:
        adam = blob["opt_state"][0]
        opt_state = AdamState(int(adam.count),
                              from_jax_layout(adam.mu, None, device)[0],
                              from_jax_layout(adam.nu, None, device)[0])
    return params, state, opt_state, blob.get("epoch", 0)


# ---- torch.distributed.checkpoint: asynchronous checkpoint directories ----

def _dcp_state_dict(params, state, opt_state, epoch):
    """The flat state dict a checkpoint directory holds: each tree's leaves
    by their path, Adam's count and the epoch as 0-d int64 tensors."""
    sd = {"params": dict(tree_leaves(params)),
          "state": dict(tree_leaves(state)),
          "epoch": torch.tensor(int(epoch))}
    if opt_state is not None:
        sd["opt_state"] = {"count": torch.tensor(int(opt_state.count)),
                           "mu": dict(tree_leaves(opt_state.mu)),
                           "nu": dict(tree_leaves(opt_state.nu))}
    return sd


class DcpCheckpointer:
    """JAX's orbax pair (``save_checkpoint_orbax`` /
    ``load_checkpoint_orbax``) on ``torch.distributed.checkpoint``: a
    checkpoint is a directory, ``save`` returns once the tensors are
    staged in host memory and writes them in the background
    (``dcp.async_save``), and ``load`` fills a template shaped like the
    saved trees.  Under a process group every rank calls ``save`` and
    ``load`` (each writes its part; replicated tensors are written once),
    coordinated over a gloo group of the checkpointer's own.  One save is
    in flight at a time."""

    def __init__(self):
        self._pending = None
        self._group = None

    def _process_group(self):
        """None without a process group; else a gloo group of the
        checkpointer's own, made on first use (every rank calls save and
        load in the same order): the background save runs its collectives
        while the train step runs its own on the default group, and two
        threads must not share one group's sequence of collectives."""
        import torch.distributed as dist
        if not dist.is_initialized():
            return None
        if self._group is None:
            self._group = dist.new_group(backend="gloo")
        return self._group

    def wait(self):
        """Blocks until the save in flight, if any, is on disk."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def save(self, dir_path, params: AudioNetParams, state: AudioNetState,
             opt_state: AdamState | None = None, epoch: int = 0,
             wait: bool = False):
        import torch.distributed.checkpoint as dcp
        self.wait()
        self._pending = dcp.async_save(
            _dcp_state_dict(params, state, opt_state, epoch),
            checkpoint_id=os.path.abspath(str(dir_path)),
            process_group=self._process_group())
        if wait:
            self.wait()

    def load(self, dir_path, params_like: AudioNetParams,
             state_like: AudioNetState, opt_state_like=None):
        """(params, state, opt_state or None, epoch) read into copies of the
        templates (fresh init values do), on their devices."""
        import torch.distributed.checkpoint as dcp
        self.wait()
        clone = lambda tree: tree_map(torch.clone, tree)  # noqa: E731
        params, state = clone(params_like), clone(state_like)
        opt = None
        if opt_state_like is not None:
            opt = AdamState(0, clone(opt_state_like.mu),
                            clone(opt_state_like.nu))
        sd = _dcp_state_dict(params, state, opt, 0)
        dcp.load(sd, checkpoint_id=os.path.abspath(str(dir_path)),
                 process_group=self._process_group())
        if opt is not None:
            opt = opt._replace(count=int(sd["opt_state"]["count"]))
        return params, state, opt, int(sd["epoch"])
