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

Checkpoints are pickles of ``{"params", "state", "opt_state", "epoch"}``
with numpy leaves in the JAX package's layouts and its class names
(``speakerguard_tpu.models.audionet.AudioNetParams``, optax's
``ScaleByAdamState`` and ``EmptyState``), which JAX's ``load_checkpoint``
reads unchanged.  Both directions go without importing jax, optax or the
JAX package: the names are written by a pickler that emits them as text,
and read by an unpickler that maps them onto stand-ins and lets through
only numpy's array reconstruction.  JAX's orbax pair has no counterpart
yet.
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


def _augment(draw, clean, aug_eps):
    """The noisy copies of ``clean``: uniform noise in [-a eps, a eps) at a
    scale a ~ U[0, 1) (reference natural_train.py:138-148)."""
    a = draw("aug_scale", ())
    return clean + (2.0 * a * aug_eps * draw("aug_noise", tuple(clean.shape))
                    - a * aug_eps)


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


def loss_and_grads(params, state, wavs, labels, cdt=None):
    """(mean CE loss, gradient tree, new BN state, logits) of the forward
    in train mode on ``wavs`` in the compute dtype ``cdt`` (None: float32;
    see ``resolve_compute_dtype``): what one train step differentiates.
    The gradient is float32 and shaped like ``params``; every output is
    detached."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.no_grad():
        feats = audionet_logmel(wavs)
    with torch.enable_grad(), _cudnn_autotune():
        logits, _, new_state = audionet_logits(
            _cast(leaves, cdt), _cast(state, cdt),
            feats if cdt is None else feats.to(cdt), train=True)
        logits = logits.to(torch.float32)
        loss = torch.mean(cross_entropy(logits, labels))
        names = [n for n, _ in tree_leaves(leaves)]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [t for _, t in tree_leaves(leaves)])))
    new_state = tree_map(lambda t: t.detach().to(torch.float32), new_state)
    return (loss.detach(), tree_rebuild(params, grads.__getitem__),
            new_state, logits.detach())


def _optimizer(optimizer):
    return Adam(optimizer) if isinstance(optimizer, (int, float)) \
        else optimizer


def _accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def make_natural_train_step(optimizer, aug_eps: float = 0.002,
                            compute_dtype=None):
    """``optimizer``: an ``optim.Adam`` or a learning rate.  Returns
    step(params, state, opt_state, wavs (B, L) scale domain, labels (B,),
    rng=None, draw_fn=None) -> (params, state, opt_state, loss, acc).  With
    ``aug_eps > 0`` the batch is [wavs; noisy wavs] and the labels are
    repeated; ``acc`` is over the doubled batch."""
    opt = _optimizer(optimizer)
    cdt = resolve_compute_dtype(compute_dtype)

    def step(params, state, opt_state, wavs, labels, rng=None,
             draw_fn=None):
        if aug_eps > 0.0:
            draw = draw_fn or generator_draw(rng, wavs.device)
            wavs_all = torch.cat([wavs, _augment(draw, wavs, aug_eps)])
            labels_all = torch.cat([labels, labels])
        else:
            wavs_all, labels_all = wavs, labels
        loss, grads, new_state, logits = loss_and_grads(
            params, state, wavs_all, labels_all, cdt)
        params, opt_state = opt.update(params, grads, opt_state)
        return (params, new_state, opt_state, loss,
                _accuracy(logits, labels_all))

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
    out.  ``compute_dtype`` sets the train substep's precision; the attack
    keeps its own."""
    opt = _optimizer(optimizer)
    cdt = resolve_compute_dtype(compute_dtype)

    def step(params, state, opt_state, wavs, labels, rng=None,
             draw_fn=None):
        b = wavs.shape[0]
        n_adv = int(b * ratio)
        adv = attack_fory(params, state, wavs[:n_adv], labels[:n_adv])
        wavs_mixed = torch.cat([adv, wavs[n_adv:]])
        if aug_eps > 0.0:
            draw = draw_fn or generator_draw(rng, wavs.device)
            wavs_all = torch.cat(
                [wavs_mixed, _augment(draw, wavs[n_adv:], aug_eps)])
            labels_all = torch.cat([labels, labels[n_adv:]])
        else:
            wavs_all, labels_all = wavs_mixed, labels
        loss, grads, new_state, logits = loss_and_grads(
            params, state, wavs_all, labels_all, cdt)
        params, opt_state = opt.update(params, grads, opt_state)
        return (params, new_state, opt_state, loss,
                _accuracy(logits[:n_adv], labels[:n_adv]),
                _accuracy(logits[n_adv:b], labels[n_adv:]))

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
