"""Weights drawn in one call per distribution: ask for every tensor's
shape first, then fill them all from one ``torch.Generator`` on the
device, so that making a model's weights takes two launches however many
tensors it has."""

import torch


class _Pool:

    def __init__(self):
        self._shapes = []
        self._buf = None

    def _ask(self, shape, post):
        """A handle that returns the tensor of ``shape`` once filled."""
        offset = sum(n for n, _, _ in self._shapes)
        count = 1
        for s in shape:
            count *= s
        self._shapes.append((count, shape, post))
        idx = len(self._shapes) - 1

        def get():
            if self._buf is None:
                raise RuntimeError("not filled yet")
            n, shp, fn = self._shapes[idx]
            return fn(self._buf[offset:offset + n].view(shp))
        return get

    def _total(self):
        return sum(n for n, _, _ in self._shapes)


class Uniform(_Pool):

    def add(self, shape, lo, hi):
        return self._ask(shape, lambda t: t * (hi - lo) + lo)

    def fill(self, gen, device):
        self._buf = torch.rand(self._total(), generator=gen, device=device)


class Normal(_Pool):

    def add(self, shape, scale):
        return self._ask(shape, lambda t: t * scale)

    def fill(self, gen, device):
        self._buf = torch.randn(self._total(), generator=gen, device=device)
