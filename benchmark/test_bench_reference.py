"""The plain references against the port's exact path on the same raw
weights, waves and dither, at small widths on the CPU.  The test imports
both; the references import nothing of the program."""

import pytest
import torch

from benchmark import harness
from conftest import small_config


@pytest.mark.parametrize("model", ["xv_plda", "iv_plda"])
def test_reference_scores_match_the_port(model, cpu):
    cfg = small_config(model)
    models = harness.part("models", model)
    ref = harness.part("reference", model).Reference(
        models.make_weights(cfg, 123, cpu), cfg, cpu)
    prog = models.build_program(models.make_weights(cfg, 123, cpu), cfg,
                                {"fast_path": {"enabled": False}}, cpu)
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(4, 8000, generator=g) * 2 - 1) * 0.3
    dither = torch.randn(4, 50, 400, generator=g)
    with torch.no_grad():
        got = prog.score(x, rng=lambda shape: dither)
        want = ref.scores(x, dither)
        plain = ref.scores(x, None)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    # float32 sums in another order: the i-vector's solve amplifies them
    assert err <= 2e-5 * scale
    # the dither is part of what is compared (at 1.0 on waves of ~10^4
    # in the int16 range it moves the scores little, but more than this)
    assert float((plain - want).abs().max()) > 5 * err


def test_reference_gradient_matches_the_port(cpu):
    """The input gradient PGD steps along, on the exact path."""
    cfg = small_config("xv_plda")
    models = harness.part("models", "xv_plda")
    ref = harness.part("reference", "xv_plda").Reference(
        models.make_weights(cfg, 5, cpu), cfg, cpu)
    prog = models.build_program(models.make_weights(cfg, 5, cpu), cfg,
                                {"fast_path": {"enabled": False}}, cpu)
    x = (torch.rand(2, 8000, generator=torch.Generator().manual_seed(1))
         * 2 - 1) * 0.3
    grads = []
    for fn in (lambda v: prog.score(v), lambda v: ref.scores(v)):
        v = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(v)[:, 0].sum(), v)
        grads.append(g)
    assert torch.allclose(grads[0], grads[1], rtol=1e-3,
                          atol=1e-4 * float(grads[1].abs().max()))
