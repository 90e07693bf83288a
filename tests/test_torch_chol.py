"""The port's batched Cholesky (ops/chol.py) and SPD solve against the JAX
package's Pallas cholesky_rt (interpret mode) and spd_solve.

On the CPU ``cholesky_rt`` runs its plain version; the CUDA kernel is held
against that plain version on the card (marked ``cuda``, skipped here, and
by chip_smoke.py).  Sizes stay at N <= 150: the Pallas interpret mode is
slow.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.models.ivector import spd_solve as jax_spd_solve
from speakerguard_tpu.ops.pallas_chol import cholesky_rt as jax_cholesky_rt

from speakerguard_tpu_torch.models.ivector import spd_solve
from speakerguard_tpu_torch.ops.chol import (MAX_N, blocked_residual,
                                             check_kernel_n, cholesky_rt,
                                             cholesky_rt_plain)
from speakerguard_tpu_torch.ops.trsv import triangular_solve_vec


def _spd(rng, b, n):
    a = rng.standard_normal((b, n, n)).astype(np.float32) * 0.1
    return (np.einsum("bij,bkj->bik", a, a)
            + (n / 10.0 + 0.5) * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


def _spd_occupancy(rng, b, n):
    """Shaped like the i-vector solve's L = I + sum_c N_c M_c^T M_c with few
    occupied components (2N / 72 of 72 dims each): R's off-diagonals are
    ~1/6 of its diagonal, so a wrong trailing update shows at once."""
    comps = -(-2 * n // 72)
    m = rng.standard_normal((comps * 72, n)) * 0.05
    occ = np.repeat(rng.uniform(0.0, 30.0, (b, comps)), 72, axis=1)
    return (np.eye(n) + np.einsum("kn,bk,km->bnm", m, occ, m)
            ).astype(np.float32)


def _oracle(spd):
    """torch.linalg.cholesky(A).mT in float64."""
    return torch.linalg.cholesky(torch.tensor(spd, dtype=torch.float64)
                                 ).mT.numpy()


@pytest.mark.parametrize("b,n", [(3, 64), (5, 150), (2, 1), (2, 129)])
@pytest.mark.parametrize("mode", ["f32", "bf16_in", "bf16_updates"])
def test_plain_matches_jax_kernel_and_oracle(b, n, mode):
    rng = np.random.default_rng(n)
    spd = _spd(rng, b, n)
    _check_plain_against_jax_and_oracle(spd, b, n, mode)


@pytest.mark.parametrize("b,n", [(3, 64), (2, 129)])
@pytest.mark.parametrize("mode", ["f32", "bf16_updates"])
def test_plain_matches_jax_kernel_on_ivector_shaped_input(b, n, mode):
    """The i-vector-shaped input, where R's off-diagonals are large enough
    that a wrong or skipped trailing update cannot hide under the bars."""
    spd = _spd_occupancy(np.random.default_rng(n), b, n)
    _check_plain_against_jax_and_oracle(spd, b, n, mode)


def _check_plain_against_jax_and_oracle(spd, b, n, mode):
    bf16_in = mode == "bf16_in"
    upd = mode == "bf16_updates"
    if bf16_in:
        # round once so both sides and the oracle factor the same matrix
        spd = np.asarray(jnp.asarray(spd).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    a_jax = jnp.asarray(spd).astype(jnp.bfloat16 if bf16_in
                                    else jnp.float32)
    want = np.asarray(jax_cholesky_rt(a_jax, nb=32, b_tile=b,
                                      interpret=True, bf16_updates=upd))
    a_t = torch.tensor(spd).to(torch.bfloat16 if bf16_in else torch.float32)
    got = cholesky_rt_plain(a_t, bf16_updates=upd).numpy()
    oracle = _oracle(spd)
    assert got.dtype == np.float32 and got.shape == (b, n, n)
    assert np.abs(np.tril(got, -1)).max(initial=0.0) == 0.0
    if upd:
        # both round the same R entries to bf16 for the trailing updates and
        # differ only in f32 summation order (measured <= 9e-7 of max |R|),
        # so they are held to each other at the f32 bar; against the f64
        # oracle each is off by the bf16 rounding itself (8 mantissa bits,
        # measured <= 5e-4 of max |R|), held at 2e-3
        scale = np.abs(oracle).max()
        np.testing.assert_allclose(got, want, atol=1e-5 * scale)
        np.testing.assert_allclose(got, oracle, atol=2e-3 * scale)
        np.testing.assert_allclose(want, oracle, atol=2e-3 * scale)
        # against its own algorithm the plain factor is exact to f32
        # round-off: A rebuilt with the same grouping and bf16 rounding
        assert blocked_residual(torch.tensor(spd), torch.tensor(got),
                                True) <= 1e-5
    else:
        # f32 factorizations of a well-conditioned matrix
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-5)


def test_wrapper_runs_plain_on_cpu_and_reads_upper_triangle_only():
    rng = np.random.default_rng(0)
    spd = _spd(rng, 2, 40)
    junk = spd + np.tril(rng.standard_normal((2, 40, 40)).astype(np.float32),
                         -1) * 100.0
    cholesky_rt.reset_counts()
    got = cholesky_rt(torch.tensor(junk))
    assert (cholesky_rt.plain_calls, cholesky_rt.launches) == (1, 0)
    np.testing.assert_allclose(got.numpy(), _oracle(spd), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        cholesky_rt(torch.zeros(3, 4, 5))
    with pytest.raises(TypeError):
        cholesky_rt(torch.zeros(1, 4, 4, dtype=torch.float64))


def test_spd_solve_value_and_grad_match_jax_with_one_factorization():
    rng = np.random.default_rng(1)
    l_mat = _spd(rng, 4, 96) * 10.0
    rhs = rng.standard_normal((4, 96)).astype(np.float32)
    w = rng.standard_normal((4, 96)).astype(np.float32)

    def jloss(lm, r):
        return jnp.sum(jnp.sin(jax_spd_solve(lm, r)) * w)

    want = np.asarray(jax_spd_solve(jnp.asarray(l_mat), jnp.asarray(rhs)))
    gl_want, gr_want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(l_mat),
                                                       jnp.asarray(rhs))
    lm = torch.tensor(l_mat, requires_grad=True)
    r = torch.tensor(rhs, requires_grad=True)
    cholesky_rt.reset_counts()
    x = spd_solve(lm, r)
    (torch.sin(x) * torch.tensor(w)).sum().backward()
    # the backward reuses the forward's factor: one factorization in all
    assert cholesky_rt.plain_calls == 1
    # f32 solves against different factorizations (LAPACK-style lower vs
    # the blocked upper sweep) of a matrix with condition ~1e2
    np.testing.assert_allclose(x.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(lm.grad.numpy(), np.asarray(gl_want),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr_want),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("transpose_a", [False, True])
def test_triangular_solve_vec_matches_jax(lower, transpose_a):
    from speakerguard_tpu.ops.trsv import triangular_solve_vec as jax_tsv
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 150, 150)).astype(np.float32) * 0.1
    fac = np.tril(a) + 2.0 * np.eye(150, dtype=np.float32)
    if not lower:
        fac = fac.transpose(0, 2, 1).copy()
    v = rng.standard_normal((3, 150)).astype(np.float32)
    want = np.asarray(jax_tsv(jnp.asarray(fac), jnp.asarray(v), lower=lower,
                              transpose_a=transpose_a))
    got = triangular_solve_vec(torch.tensor(fac), torch.tensor(v),
                               lower=lower, transpose_a=transpose_a).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [1, 64, 129])
@pytest.mark.parametrize("kind", ["dominant", "occupancy"])
@pytest.mark.parametrize("upd", [False, True])
def test_blocked_residual_holds_plain_and_sees_rounding(n, kind, upd):
    """The bar chip_smoke.py holds the kernel to: the plain factor rebuilds
    A to 1e-5 of max |A| under its own rounding mode; on the occupancy
    input the other mode's rounding alone breaks that bar."""
    rng = np.random.default_rng(n + 7)
    spd = torch.tensor((_spd if kind == "dominant" else _spd_occupancy)(
        rng, 3, n))
    r = cholesky_rt_plain(spd, bf16_updates=upd)
    assert blocked_residual(spd, r, upd) <= 1e-5
    if kind == "occupancy" and n > 32:
        assert blocked_residual(spd, r, not upd) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,dtype,upd,kind", [
    (64, 600, torch.float32, False, "dominant"),
    (64, 600, torch.bfloat16, False, "dominant"),
    (64, 600, torch.float32, True, "dominant"),
    (64, 600, torch.float32, False, "occupancy"),
    (64, 600, torch.float32, True, "occupancy"),
    (3, 129, torch.float32, False, "dominant"),
    (2, 1, torch.float32, False, "dominant"),
    (1, 600, torch.float32, False, "dominant"),
    (2, 617, torch.float32, False, "dominant"),
    (1, MAX_N, torch.float32, False, "dominant")])
def test_cuda_kernel_matches_plain(b, n, dtype, upd, kind):
    """The hand-written kernel against its plain version on the card: both
    to the plain factor and to A rebuilt by its own algorithm, at 1e-5.
    bf16_updates on the occupancy input is held to the plain factor at
    2e-3: among its 11.5M R entries an f32 summation-order ulp can flip the
    bf16 rounding of a few, so the two factors differ by ~2.4e-4 of max |R|
    while both are right; a skipped trailing update errs far above that
    bar on this input, and unrounded operands break the residual bar
    (test_blocked_residual_holds_plain_and_sees_rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    make = _spd if kind == "dominant" else _spd_occupancy
    spd = torch.tensor(make(np.random.default_rng(n), b, n),
                       device="cuda").to(dtype)
    cholesky_rt.reset_counts()
    got = cholesky_rt(spd, bf16_updates=upd)
    torch.cuda.synchronize()
    assert cholesky_rt.launches == 1
    want = cholesky_rt_plain(spd, bf16_updates=upd)
    assert torch.all(torch.tril(got, -1) == 0)
    assert blocked_residual(spd, got, upd) <= 1e-5
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= (2e-3 if upd and kind == "occupancy" else 1e-5)


@pytest.mark.parametrize("n,fits", [(1, True), (600, True), (MAX_N, True),
                                    (MAX_N + 1, False), (4096, False)])
def test_kernel_size_limit(n, fits):
    """The kernels keep the 32-row panel stripe of N columns in one block's
    shared memory: N above MAX_N raises a ValueError naming the limit (the
    CUDA wrappers check it before any launch; the plain versions have no
    limit)."""
    if fits:
        check_kernel_n(n)
    else:
        with pytest.raises(ValueError, match=str(MAX_N)):
            check_kernel_n(n)


@pytest.mark.cuda
def test_cuda_kernel_rejects_n_above_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    cholesky_rt.reset_counts()
    a = torch.eye(MAX_N + 1, device="cuda")[None]
    with pytest.raises(ValueError, match=str(MAX_N)):
        cholesky_rt(a)
    assert (cholesky_rt.launches, cholesky_rt.plain_calls) == (0, 0)
