"""optax.adam in PyTorch, as the JAX package uses it: CW2's Adam on the
modifier (``adam_update``, one tensor) and the trainer's Adam over the
AudioNet parameters (``Adam``, a tree); and optax.sgd (``SGD``), which the
data-parallel tests step with.

The state mirrors optax's ``ScaleByAdamState``: ``count`` (the steps taken)
and the moments ``mu`` and ``nu`` as trees shaped like the parameters.
The count is a Python int here, so a step reads nothing back from the
device.
"""

from typing import NamedTuple

import torch

from speakerguard_tpu_torch.models.base import (tree_leaves, tree_map,
                                                tree_rebuild)

# optax.adam's defaults, which the JAX package uses
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_update(grad, mu, nu, count, lr):
    """One step of optax.adam(lr) (eps_root 0) in optax's order of
    operations.  ``count`` is the step's 1-based count.  Returns (update,
    mu, nu); the update is added to the parameter."""
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * grad ** 2 + ADAM_B2 * nu
    # optax forms decay**count as a float32 pow; a Python int exponent
    # would take torch's repeated-product path, which rounds differently
    t = torch.full((), float(count), device=grad.device)
    bc1 = 1 - torch.pow(torch.full_like(t, ADAM_B1), t)
    bc2 = 1 - torch.pow(torch.full_like(t, ADAM_B2), t)
    update = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
    return update, mu, nu


class AdamState(NamedTuple):
    count: int   # steps taken (optax's int32 count)
    mu: tuple    # first moments, shaped like the parameters
    nu: tuple    # second moments


class Adam:
    """optax.adam(lr) over a tree of float32 tensors (NamedTuples and
    tuples): ``init(params)``, then ``update(params, grads, state) ->
    (params, state)``, each leaf ``p + adam_update(g, ...)`` as
    optax.apply_updates adds it.  The leaves are updated as one flat
    vector (a dozen elementwise launches a step, not a dozen a leaf), which
    computes each element as ``adam_update`` does; the returned trees are
    views into it."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(self, params, grads, state: AdamState):
        count = state.count + 1
        leaves = dict(tree_leaves(params))

        def flat(tree):
            return torch.cat([t.reshape(-1) for _, t in tree_leaves(tree)])

        def unflat(vec):
            parts = torch.split(vec, [t.numel() for t in leaves.values()])
            views = {n: v.view(t.shape)
                     for (n, t), v in zip(leaves.items(), parts)}
            return tree_rebuild(params, views.__getitem__)

        update, mu, nu = adam_update(flat(grads), flat(state.mu),
                                     flat(state.nu), count, self.lr)
        return (unflat(flat(params) + update),
                AdamState(count, unflat(mu), unflat(nu)))


class SGD:
    """optax.sgd(lr) without momentum over a tree: ``init(params) -> ()``,
    ``update(params, grads, state) -> (params, state)``, each leaf
    ``p + (-lr g)`` as optax scales and applies the update."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, params, grads, state):
        return tree_map(lambda p, g: p + (-self.lr) * g, params, grads), state
