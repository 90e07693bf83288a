"""Attack base: the uniform attack(x, y) -> (adver_x, success) contract
(reference attack/Attack.py) plus shared helpers.

Port of speakerguard_tpu/attacks/base.py.  Attacks operate on waveforms in
the *scale* domain ([-1, 1)) with shape (B, L) (the reference's (B, 1, T) is
accepted and squeezed), on the device of the model they attack.

``mesh=`` (a ``DeviceMesh`` with a ``"data"`` axis, the JAX package's
``shard_inputs``): every rank is given the same full (x, y); each chunk of
``run_batched`` is split over ``"data"`` (``parallel.mesh.BatchShard``),
each rank attacks its rows, and ``all_gather`` rebuilds the chunk's
adversarial audio and success list on every rank, so ``attack()`` returns
what the one-process call returns.  While a chunk runs, ``self._shard``
holds its split, and the attacks route through the helpers below: each
draw is the chunk's global draw, of which the rank takes its rows
(``_draw_rows``, ``_row_rng``), and each host decision that the
one-process loop takes over the whole batch reads the all-reduced value
(``_any``, ``_mean``), so every rank runs the same loop.  A defended model
with defenses draws through its own ``draw_fn``, which knows no shard:
under a mesh it is refused.
"""

import warnings

import numpy as np
import torch

from speakerguard_tpu_torch.attacks.losses import compare
from speakerguard_tpu_torch.parallel.mesh import BatchShard


def make_generator(rng, device) -> torch.Generator:
    """``rng``: a torch.Generator (used as is), an int seed, or None
    (seed 0).  The generator draws the attack's init noise and dither."""
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if rng is None else int(rng))
    return gen


class Attack:
    targeted: bool = False
    batch_size: int = 1
    mesh = None    # optional DeviceMesh: shard each chunk over 'data'
    _shard = None  # the split of the chunk running under the mesh

    def attack(self, x, y, rng=None):
        raise NotImplementedError

    def compare(self, y, y_pred, targeted):
        return compare(y, y_pred, targeted).tolist()

    def run_batched(self, attack_batch_fn, x, y, rng, batch_size=None):
        """Split the input into batch_size chunks like the reference's
        attack() loops (FGSM.py:83-96); ``rng`` (a torch.Generator) advances
        through the chunks in order.  Under a mesh each chunk is split over
        its 'data' axis (module docstring)."""
        n = x.shape[0]
        bs = min(batch_size or getattr(self, "batch_size", n) or n, n)
        if bs >= n:
            return self._run_chunk(attack_batch_fn, x, y, rng)
        advers, successes = [], []
        for s in range(0, n, bs):
            a, su = self._run_chunk(attack_batch_fn, x[s:s + bs],
                                    y[s:s + bs], rng)
            advers.append(a)
            successes += list(su)
        return torch.cat(advers, dim=0), successes

    def _run_chunk(self, attack_batch_fn, x, y, rng):
        if self.mesh is None:
            return attack_batch_fn(x, y, rng)
        if getattr(self.model, "num_defenses", 0):
            raise NotImplementedError(
                "mesh=: a defended model's defenses draw through their own "
                "draw_fn, which is not sharded; attack it on one process")
        shard = BatchShard.of(self.mesh, x.shape[0])
        self._shard = shard
        try:
            adver, success = attack_batch_fn(shard.local(x), shard.local(y),
                                             rng)
        finally:
            self._shard = None
        flags = torch.tensor(success, dtype=torch.uint8, device=x.device)
        return (shard.gather(adver),
                shard.gather(flags).to(torch.bool).tolist())

    # ---- shard-aware helpers: the plain operation without a mesh ----
    def _any(self, t: torch.Tensor) -> bool:
        """Whether any lane of the (global) batch is set."""
        return bool(t.any()) if self._shard is None else self._shard.any(t)

    def _mean(self, t: torch.Tensor) -> torch.Tensor:
        """The (global) batch mean of a per-lane tensor."""
        return t.mean() if self._shard is None else self._shard.mean(t)

    def _gather_np(self, a: np.ndarray, device) -> np.ndarray:
        """A per-lane host array of the (global) batch (gathered through
        ``device``, the one the group's collectives take)."""
        if self._shard is None:
            return a
        return self._shard.gather(torch.as_tensor(a, device=device)).cpu(
            ).numpy()

    def _draw_rows(self, draw, shape, dim=0, major="sample"):
        """``draw(shape)``, or under a mesh this rank's rows of the global
        draw (``BatchShard.draw_rows``)."""
        if self._shard is None:
            return draw(tuple(shape))
        return self._shard.draw_rows(draw, tuple(shape), dim, major)

    def _row_rng(self, rng, major="sample"):
        """What the model's frontend draws its dither from: ``rng`` (a
        torch.Generator, a draw function or None), or under a mesh a draw
        function that gives this rank's rows of the global draw (dither
        noise of the batch's frames, (rows, T, W); ``major`` says how an
        evaluation folds samples into its rows)."""
        if self._shard is None or rng is None:
            return rng
        if isinstance(rng, torch.Generator):
            gen = rng

            def draw(shape):
                return torch.randn(shape, generator=gen, device=gen.device,
                                   dtype=torch.float32)
        else:
            draw = rng
        return lambda shape: self._draw_rows(draw, shape, 0, major)


def normalize_wav_input(x, device=None):
    """(B, 1, L) | (B, L) | (L,) -> ((B, L) float32 tensor, restore_fn).

    Also a domain gate: every attack entry point funnels through here, so
    origin-domain (int16-valued float) audio is rejected loudly instead of
    silently attacking a 32768x mis-scaled signal."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    assert_scale_domain(x)
    shape = x.shape
    if x.ndim == 1:
        flat = x[None, :]
    elif x.ndim == 3:
        if x.shape[1] != 1:
            raise ValueError("only mono audio")
        flat = x[:, 0, :]
    else:
        flat = x
    return flat, lambda y: torch.reshape(y, shape)


def assert_scale_domain(x: torch.Tensor, what="attack input"):
    """Raise if an array is clearly not scale-domain audio (|x| >> 1), warn
    if it is implausibly quiet (scale-domain audio divided by 2**15 again).
    Attacks operate in [-1, 1) (reference attackMain.py:188-189)."""
    m = float(torch.max(torch.abs(x))) if x.numel() else 0.0
    if m > 2.0:
        raise ValueError(
            f"{what} has max|x|={m:.1f}; expected scale-domain audio in "
            "[-1, 1). Origin-domain (int16-valued float) audio must be "
            "divided by 2**15 exactly once before attacking; "
            "Dataset(normalize=True) already yields the scale domain.")
    if x.numel() and 0.0 < m < 1e-3:
        warnings.warn(
            f"{what} has max|x|={m:.2e}; implausibly small for audio — "
            "was scale-domain input divided by 2**15 a second time? "
            "Dataset(normalize=True) already yields the scale domain.",
            stacklevel=2)
