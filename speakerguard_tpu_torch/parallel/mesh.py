"""Data parallelism over torch.distributed: meshes, sharded train and attack
steps, and the launcher of the CLIs.

Port of speakerguard_tpu/parallel/mesh.py.  JAX shards one process's
arrays over a device mesh and XLA inserts the collectives.  Here one
process runs per device, a ``DeviceMesh`` names the ranks' axes with JAX's
names (``"data"``, ``"eot"``), and the code calls the collectives itself.
The contract: an N-rank run computes what the one-process run computes on
the global batch.  Three rules keep it:

- A batch sharded over ``"data"`` is split contiguously: index i of the
  axis holds rows [i n/N, (i+1) n/N) (``BatchShard``; n must divide).
- Every random draw is the global batch's draw, of which a rank takes its
  rows (``BatchShard.draw_rows``): the ranks draw from generators seeded
  alike, in the same order, so no rank's stream runs ahead of another's.
- Every host decision that the one-process run takes on the whole batch
  (an any over lanes, a batch mean) reads the all-reduced value, so every
  rank runs the same loop with the same trip count, and the collectives
  inside it stay matched.

Train-mode BatchNorm takes global-batch statistics: its sums are
all-reduced, with gradient (``all_reduce_sum``), before it normalises, as
``jnp.mean`` inside JAX's sharded step reduces over the sharded batch.
The loss and accuracies are global means and the gradients are summed
over the ranks, so every rank applies the same update.

Launching: ``spawn(fn, world, ...)`` starts ``world`` ranks with the spawn
method (CUDA may be live in the parent), joined through a ``FileStore`` in
a temporary directory, and returns each rank's result; ``launch`` is what
the CLIs call for ``-n_devices N``: under ``torchrun`` it checks N against
the world size and joins the group from the environment, in a plain
process it spawns N ranks.  The backend is named, never guessed:
``launch`` takes ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``;
``spawn`` takes the one its caller names (the tests and the smoke run
gloo ranks on one card).
"""

import datetime
import os
import pickle
import tempfile
from typing import NamedTuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def make_mesh(n_devices=None, axes=("data",), shape=None,
              device_type="cuda"):
    """A ``DeviceMesh`` over the ranks of the initialised process group,
    with JAX's axis names.  ``n_devices`` (default: the world size) must
    equal the world size; ``shape`` is required for more than one axis."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, launch or spawn)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if shape is None:
        if len(axes) != 1:
            raise ValueError("give shape for multi-axis meshes")
        shape = (n,)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def axis_info(mesh, axis: str):
    """(process group, this rank's index, size) of ``axis`` of ``mesh``;
    (None, 0, 1) for no mesh."""
    if mesh is None:
        return None, 0, 1
    sub = mesh[axis]
    return sub.get_group(), sub.get_local_rank(), sub.size()


def rank_device(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names this thread's
    current card, which ``launch`` and ``spawn`` set to the rank's card in
    the rank's main thread only (the current card is per thread; another
    thread, such as ``parallel.input.prefetch``'s, starts on card 0).  A
    rank resolves its device here, in its main thread, and hands the
    indexed device to whatever runs elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A detached, contiguous copy: the buffer a collective fills in place
    (the backends take contiguous tensors only)."""
    return t.detach().clone(memory_format=torch.contiguous_format)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``, whose gradient is the sum of the gradients: the
    total loss is the sum of the ranks' losses, each of which reads the
    global sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable."""
    return _AllReduceSum.apply(t, group)


class BatchShard(NamedTuple):
    """This rank's rows of a global batch of ``n`` rows sharded over one
    mesh axis: [start, stop)."""
    group: object
    index: int
    size: int
    n: int
    start: int
    stop: int

    @classmethod
    def of(cls, mesh, n: int, axis: str = "data") -> "BatchShard":
        group, index, size = axis_info(mesh, axis)
        if n % size:
            raise ValueError(f"batch {n} must divide over the {size}-way "
                             f"{axis} axis")
        rows = n // size
        return cls(group, index, size, n, index * rows, (index + 1) * rows)

    @classmethod
    def of_local(cls, mesh, rows: int, axis: str = "data") -> "BatchShard":
        return cls.of(mesh, rows * axis_info(mesh, axis)[2], axis)

    @property
    def rows(self) -> int:
        return self.stop - self.start

    def local(self, t, dim: int = 0):
        """This rank's rows of a global tensor (along ``dim``)."""
        return t.narrow(dim, self.start, self.rows)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (no gradient)."""
        out = _copy(t)
        dist.all_reduce(out, group=self.group)
        return out

    def max(self, t: torch.Tensor) -> torch.Tensor:
        out = _copy(t)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def any(self, t: torch.Tensor) -> bool:
        """Whether any element of ``t`` on any rank is true."""
        flag = torch.any(t).to(torch.int32).reshape(1)
        return bool(self.max(flag))

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's mean of a per-row tensor ``t`` (rows,)."""
        return self.sum(t.sum()) / self.n

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's rows (along dim 0)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def draw_rows(self, draw, shape, dim: int = 0, major: str = "sample"):
        """This rank's rows of the global draw ``draw(global shape)``, for a
        draw whose local ``shape`` holds the rows along ``dim``.  When
        ``shape[dim]`` is m times this rank's rows (m groups of rows,
        folded), ``major`` says how they fold: ``"sample"`` m blocks of the
        batch (index s * rows + r), ``"batch"`` m entries per row (index
        r * m + s)."""
        m, rem = divmod(shape[dim], self.rows) if self.rows else (0, 0)
        if rem or (shape[dim] and not m):
            raise ValueError(f"draw of {shape[dim]} rows along {dim} for a "
                             f"shard of {self.rows}")
        gshape = list(shape)
        gshape[dim] = m * self.n
        g = torch.as_tensor(draw(tuple(gshape)))
        rest = g.shape[dim + 1:]
        if major == "sample":
            g = g.reshape(*g.shape[:dim], m, self.n, *rest)
            return g.narrow(dim + 1, self.start, self.rows).reshape(shape)
        g = g.reshape(*g.shape[:dim], self.n, m, *rest)
        return g.narrow(dim, self.start, self.rows).reshape(shape)


def shard_batch(x, mesh, axis: str = "data"):
    """This rank's rows of the global batch ``x`` (leading axis)."""
    x = torch.as_tensor(x)
    return BatchShard.of(mesh, x.shape[0], axis).local(x)


def replicate(tree, mesh):
    """Every tensor leaf of ``tree`` (a nest of NamedTuples and tuples)
    broadcast from rank 0 of the mesh's world; other leaves as they
    are."""
    from speakerguard_tpu_torch.models.base import tree_map
    if mesh is None:
        return tree

    def bcast(t):
        if not isinstance(t, torch.Tensor):
            return t
        out = _copy(t)
        dist.broadcast(out, src=0)
        return out
    return tree_map(bcast, tree)


def all_reduce_tree(tree, group):
    """Every tensor leaf of ``tree`` summed over ``group`` in one
    collective (the leaves share one dtype)."""
    from speakerguard_tpu_torch.models.base import (tree_leaves,
                                                    tree_rebuild)
    leaves = dict(tree_leaves(tree))
    flat = torch.cat([t.reshape(-1) for t in leaves.values()])
    dist.all_reduce(flat, group=group)
    parts = torch.split(flat, [t.numel() for t in leaves.values()])
    views = {n: p.view(t.shape) for (n, t), p in zip(leaves.items(), parts)}
    return tree_rebuild(tree, views.__getitem__)


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------

def sharded_train_step(step_fn, mesh, axis: str = "data"):
    """A train step of ``models/training.py`` run data-parallel: each rank
    passes its rows of the global batch (``shard_batch``) and replicated
    params, state and optimiser state, and gets back what the one-process
    step returns on the global batch.  ``draw_fn`` gives the global
    batch's draws."""

    def step(params, state, opt_state, wavs, labels, rng=None,
             draw_fn=None):
        shard = BatchShard.of_local(mesh, wavs.shape[0], axis)
        return step_fn(params, state, opt_state, wavs, labels, rng=rng,
                       draw_fn=draw_fn, shard=shard)
    return step


def sharded_attack_grad(score_fn, loss_fn, mesh):
    """EOT-averaged input gradient over a (data, eot) mesh: the batch over
    ``"data"``, the EOT repeats over ``"eot"``, the mean all-reduced over
    ``"eot"``.  Returns fn(x (b, L), y (b,), rngs) -> (loss (b,), grad
    (b, L)) for this rank's rows, where ``rngs`` holds one entry per EOT
    repeat (E of them, E divisible by the eot axis), each what
    ``score_fn(x, rng)`` takes; this rank scores repeats [j E/M, (j+1)
    E/M) of its eot index j."""
    group, j, m = axis_info(mesh, "eot")

    def fn(x, y, rngs):
        e = len(rngs)
        if e % m:
            raise ValueError(f"{e} EOT repeats over a {m}-way eot axis")
        total = torch.zeros((x.shape[0], 1 + x.shape[1]), device=x.device,
                            dtype=x.dtype)
        for rng in rngs[j * e // m:(j + 1) * e // m]:
            xx = x.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = loss_fn(score_fn(xx, rng), y)
                (g,) = torch.autograd.grad(loss.sum(), xx)
            total[:, 0] += loss.detach()
            total[:, 1:] += g
        if group is not None:
            dist.all_reduce(total, group=group)
        total = total / e
        return total[:, 0], total[:, 1:]
    return fn


def sharded_nes_grad(eot_fn, mesh, *, samples_per_draw: int, sigma: float,
                     num_classes: int, samples_batch: int = None):
    """NES gradient estimate over a (data, eot) mesh: the batch over
    ``"data"``, the antithetic sample pairs over ``"eot"``, the sample
    means all-reduced over ``"eot"``.  Returns fn(x (b, L), y (b,), noise
    (samples_per_draw // 2, n, L), rng=None) -> ``adaptive.nes.nes_grad``'s
    quintuple for this rank's rows; ``noise`` is the global batch's draw
    (n rows), of which the rank takes its rows and its pairs."""
    from speakerguard_tpu_torch.adaptive import nes
    group, j, m = axis_info(mesh, "eot")
    half = samples_per_draw // 2
    if half % m:
        raise ValueError(f"{half} sample pairs over a {m}-way eot axis")

    def fn(x, y, noise, rng=None):
        shard = BatchShard.of_local(mesh, x.shape[0])
        mine = shard.local(noise, dim=1)[j * half // m:(j + 1) * half // m]
        s_loc = 2 * mine.shape[0]
        mean_loss, grad, adv_loss, adv_score, predict = nes.nes_grad(
            eot_fn, x, y, mine, samples_per_draw=s_loc, sigma=sigma,
            num_classes=num_classes, rng=rng, samples_batch=samples_batch)
        total = torch.cat([mean_loss[:, None], grad], dim=1) * s_loc
        if group is not None:
            dist.all_reduce(total, group=group)
        total = total / (2 * half)
        return total[:, 0], total[:, 1:], adv_loss, adv_score, predict
    return fn


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_main(rank, world, backend, store_path, devices, timeout_s, fn,
               args, out_dir):
    """One spawned rank: pick its device, join the group, run ``fn(*args)``
    and write its result for the parent."""
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), *, backend: str, devices=None,
          timeout_s: int = DEFAULT_TIMEOUT_S):
    """Runs ``fn(*args)`` on ``world`` spawned ranks in one process group
    and returns their results, rank by rank.  ``fn`` must be importable by
    name (a module-level function) and its arguments picklable.
    ``devices``: one device string per rank (default ``cpu`` for each);
    a collective that waits longer than ``timeout_s`` raises, and the
    failure of one rank ends the others."""
    import torch.multiprocessing as mp
    devices = list(devices or ["cpu"] * world)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main,
                 args=(world, backend, os.path.join(tmp, "store"), devices,
                       timeout_s, fn, tuple(args), tmp),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def launch(fn, args, n_devices: int, device):
    """Runs ``fn(args)`` on ``n_devices`` ranks joined with
    ``default_backend(device)`` and returns rank 0's result.  Under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set), the world size must be
    ``n_devices`` and this process is one rank; in a plain process,
    ``n_devices`` ranks are spawned, rank r on ``cuda:r`` for a CUDA device
    (raises when fewer cards are visible).  Each rank's current card is
    its own in its main thread (``rank_device``)."""
    device = torch.device(device)
    backend = default_backend(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n_devices:
            raise ValueError(f"-n_devices {n_devices} under a torchrun "
                             f"world of {world}")
        if not dist.is_initialized():
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        return fn(args)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count < n_devices:
            raise RuntimeError(f"-n_devices {n_devices} needs {n_devices} "
                               f"CUDA devices; {count} visible")
        devices = [f"cuda:{r}" for r in range(n_devices)]
    else:
        devices = [str(device)] * n_devices
    return spawn(fn, n_devices, (args,), backend=backend,
                 devices=devices)[0]


def is_rank0() -> bool:
    """Whether this process is rank 0 (or no group is initialised)."""
    return not dist.is_initialized() or dist.get_rank() == 0
