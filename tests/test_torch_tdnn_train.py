"""The x-vector TDNN's train mode in the port (models/tdnn.py
``tdnn_embedding(train=True, rng=)`` and ``tdnn_forward``) against the JAX
package's (speakerguard_tpu/models/tdnn.py:292-335): the exact blocks, and
``noise_eps`` times standard normal noise added to the last block's
output.  JAX's ``normal(rng, x.shape)`` draw goes into the port through a
draw function.  The noise is raised to ``noise_eps`` 0.5 here so that it
shows above float32 rounding (at the default 1e-5 it sits at the
tolerance).  Bar: tests/test_torch_tdnn.py's float32 one, rtol 1e-5 and
atol 1e-5 of the largest entry."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.models import tdnn as JT
from speakerguard_tpu.models.xv_plda import random_xv_plda_params

from speakerguard_tpu_torch.convert import from_jax_params
from speakerguard_tpu_torch.models import tdnn as TT
from speakerguard_tpu_torch.models.base import FastPath

from test_torch_kenan import one_cpu_thread  # noqa: F401

EPS = 0.5


@pytest.fixture(scope="module")
def tdnn():
    params = random_xv_plda_params(np.random.default_rng(1234))
    port = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    return params.tdnn, port.tdnn


def _feats(seed, b=3, t=60):
    return np.random.default_rng(seed).standard_normal((b, t, 30)).astype(
        np.float32)


def _f32_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _jax_normal(key):
    """JAX's draw under ``key`` as the port's draw function; records the
    shapes it was asked for."""
    shapes = []

    def draw(shape):
        shapes.append(shape)
        return np.asarray(jax.random.normal(key, shape, jnp.float32))
    draw.shapes = shapes
    return draw


@pytest.mark.parametrize("fast", [None, FastPath()], ids=["exact", "fast"])
def test_train_embedding_matches_jax(tdnn, fast):
    """train=True adds JAX's noise after the last block and runs the exact
    blocks, also when a fast path is given (JAX: fast and not train)."""
    jp, tp = tdnn
    feats, key = _feats(3), jax.random.PRNGKey(8)
    want = np.asarray(JT.tdnn_embedding(jp, jnp.asarray(feats), train=True,
                                        rng=key, noise_eps=EPS,
                                        fast=fast is not None))
    draw = _jax_normal(key)
    got = TT.tdnn_embedding(tp, torch.tensor(feats), fast=fast, train=True,
                            rng=draw, noise_eps=EPS).numpy()
    assert draw.shapes == [(3, 30, 1500)]   # the last block's output
    _f32_close(got, want)
    clean = TT.tdnn_embedding(tp, torch.tensor(feats)).numpy()
    assert np.abs(got - clean).max() > 1e3 * 1e-5 * np.abs(clean).max()


def test_train_forward_matches_jax(tdnn):
    jp, tp = tdnn
    feats, key = _feats(5), jax.random.PRNGKey(9)
    want = np.asarray(JT.tdnn_forward(jp, jnp.asarray(feats), train=True,
                                      rng=key))
    got = TT.tdnn_forward(tp, torch.tensor(feats), train=True,
                          rng=_jax_normal(key)).numpy()
    assert got.shape == (3, 251)
    _f32_close(got, want)


def test_train_without_rng_adds_no_noise_and_generator_draws(tdnn):
    """As in JAX, train mode without an rng adds nothing; a torch.Generator
    draws the noise itself, the same for the same seed."""
    _, tp = tdnn
    x = torch.tensor(_feats(7))
    assert torch.equal(TT.tdnn_embedding(tp, x, train=True),
                       TT.tdnn_embedding(tp, x))
    a, b = (TT.tdnn_embedding(tp, x, train=True, noise_eps=EPS,
                              rng=torch.Generator().manual_seed(1))
            for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, TT.tdnn_embedding(tp, x))
