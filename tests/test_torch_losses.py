"""The port's attack losses, decisions and range helpers against the JAX
package on the same scores (exact float32 elementwise math: tight bars)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speakerguard_tpu.attacks import losses as jl
from speakerguard_tpu.models.base import decide as jax_decide
from speakerguard_tpu.utils.ranges import check_input_range as jax_range

from speakerguard_tpu_torch.attacks import losses as tl
from speakerguard_tpu_torch.models.base import decide
from speakerguard_tpu_torch.utils.ranges import check_input_range


def _scores_labels(task, seed=0):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((8, 5)).astype(np.float32) * 3.0
    if task == "SV":
        scores = scores[:, :1]
        labels = np.array([0, -1] * 4)
    else:
        labels = np.array([0, 1, 2, 3, 4, -1, 2, -1])
    return scores, labels


@pytest.mark.parametrize("task", ["CSI", "SV", "OSI"])
@pytest.mark.parametrize("targeted", [False, True])
@pytest.mark.parametrize("loss_name", ["Entropy", "Margin"])
def test_resolve_loss_matches_jax(task, targeted, loss_name):
    scores, labels = _scores_labels(task)
    kw = dict(loss_name=loss_name, targeted=targeted, task=task,
              threshold=0.7, confidence=0.1, clip_max=False)
    jfn, jsign = jl.resolve_loss(**kw)
    tfn, tsign = tl.resolve_loss(**kw)
    assert jsign == tsign
    want = np.asarray(jfn(jnp.asarray(scores), jnp.asarray(labels)))
    got = tfn(torch.tensor(scores), torch.tensor(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_margin_clip_and_vote_and_compare_match_jax():
    scores, labels = _scores_labels("CSI", seed=1)
    want = np.asarray(jl.margin_loss(jnp.asarray(scores), jnp.asarray(labels),
                                     task="OSI", threshold=0.2))
    got = tl.margin_loss(torch.tensor(scores), torch.tensor(labels),
                         task="OSI", threshold=0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got >= 0).all()
    dec = np.random.default_rng(2).integers(-1, 5, (5, 8))
    assert (tl.majority_vote(torch.tensor(dec), 5).tolist()
            == np.asarray(jl.majority_vote(jnp.asarray(dec), 5)).tolist())
    assert (tl.compare(torch.tensor(labels), torch.tensor(dec[0]), True)
            .tolist() == np.asarray(jl.compare(jnp.asarray(labels),
                                               jnp.asarray(dec[0]), True))
            .tolist())


@pytest.mark.parametrize("threshold", [float("-inf"), 0.5])
def test_decide_matches_jax(threshold):
    scores, _ = _scores_labels("CSI", seed=3)
    want_d, _ = jax_decide(jnp.asarray(scores), threshold)
    got_d, _ = decide(torch.tensor(scores), threshold)
    assert got_d.tolist() == np.asarray(want_d).tolist()


@pytest.mark.parametrize("scale", [0.5, 1.05, 1.2, 30000.0])
@pytest.mark.parametrize("range_type", ["scale", "origin"])
def test_check_input_range_matches_jax(scale, range_type):
    """The 0.9-margin rule, on both sides of its boundary."""
    x = np.linspace(-scale, scale, 101).astype(np.float32)
    want = np.asarray(jax_range(jnp.asarray(x), range_type))
    got = check_input_range(torch.tensor(x), range_type).numpy()
    np.testing.assert_array_equal(got, want)
