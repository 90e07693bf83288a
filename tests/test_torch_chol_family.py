"""The rest of the port's Cholesky family (ops/chol.py ``cholesky_rt_dinv``
and ``chol_solve``, the ``dinv_t`` block substitution of ops/trsv.py and the
``solver`` choice of models/ivector.py ``spd_solve``) against the JAX
package's Pallas kernels in interpret mode, its trsv and its spd_solve under
the matching SG_CHOL_* settings.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against those plain versions on the card (marked ``cuda``, skipped here, and
by chip_smoke.py).  Sizes stay at N <= 150: the Pallas interpret mode is
slow.  N = 150 has two 128-row diagonal blocks, the second ragged.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.models.ivector import spd_solve as jax_spd_solve
from speakerguard_tpu.ops.pallas_chol import chol_solve as jax_chol_solve
from speakerguard_tpu.ops.pallas_chol import (
    cholesky_rt_dinv as jax_cholesky_rt_dinv)
from speakerguard_tpu.ops.trsv import triangular_solve_vec as jax_tsv

from speakerguard_tpu_torch.models.ivector import spd_solve
from speakerguard_tpu_torch.ops.chol import (
    MAX_N, chol_solve, chol_solve_plain, cholesky_rt,
    cholesky_rt_dinv, cholesky_rt_dinv_plain, cholesky_rt_plain,
    diag_block_inverses_t)
from speakerguard_tpu_torch.ops.trsv import triangular_solve_vec

from test_torch_chol import _spd, _spd_occupancy

# the JAX settings that select each solver of the port (JAX ivector.py
# _chol_factor / _solve_kind); SG_CHOL_NB=32 groups JAX's sweep like the
# port's, SG_CHOL_BTILE is set to the batch by _jax_env
JAX_SOLVER_ENV = {
    "cholesky_rt": {"SG_CHOL_PALLAS": "1", "SG_CHOL_EMIT_DINV": "0"},
    "cholesky_rt_dinv": {"SG_CHOL_PALLAS": "1", "SG_CHOL_EMIT_DINV": "1"},
    "chol_solve": {"SG_CHOL_PALLAS": "fused", "SG_CHOL_EMIT_DINV": "0"},
}


def _jax_env(monkeypatch, solver, batch):
    for k, v in {**JAX_SOLVER_ENV[solver], "SG_CHOL_NB": "32",
                 "SG_CHOL_BTILE": str(batch)}.items():
        monkeypatch.setenv(k, v)


def _padded(r, m=128):
    """R padded to a multiple of m with identity on the pad diagonal."""
    b, n = r.shape[0], r.shape[-1]
    npad = -(-n // m) * m
    rp = np.zeros((b, npad, npad), np.float32)
    rp[:, :n, :n] = r
    for j in range(n, npad):
        rp[:, j, j] = 1.0
    return rp


def _inv_times_d_err(r, dinv_t, m=128):
    """max |dinv_t[:, i]^T D_i - I| over the diagonal blocks (JAX's check,
    tests/test_pallas.py:264-272)."""
    rp = _padded(np.asarray(r), m)
    err = 0.0
    for i in range(rp.shape[-1] // m):
        d_blk = rp[:, i * m:(i + 1) * m, i * m:(i + 1) * m]
        inv = np.asarray(dinv_t)[:, i].transpose(0, 2, 1)
        err = max(err, float(np.abs(inv @ d_blk - np.eye(m)).max()))
    return err


@pytest.mark.parametrize("b,n", [(3, 70), (2, 150)])
@pytest.mark.parametrize("kind", ["dominant", "occupancy"])
@pytest.mark.parametrize("mode", ["f32", "bf16_in", "bf16_updates"])
def test_dinv_plain_matches_jax_kernel(b, n, kind, mode):
    """R as the cholesky_rt tests hold it, and bit for bit the plain
    cholesky_rt factor; dinv_t inverts R's diagonal blocks to JAX's 5e-5
    and matches JAX's dinv_t: to f32 round-off (1e-6 of its scale) in f32
    arithmetic; with bf16_updates JAX's identity block rides the bf16
    inner updates of its sweep, so its dinv_t carries bf16 rounding
    (measured <= 6.1e-4 of its scale), held at 2e-3 as the bf16 factors
    are."""
    spd = (_spd if kind == "dominant" else _spd_occupancy)(
        np.random.default_rng(n), b, n)
    bf16_in, upd = mode == "bf16_in", mode == "bf16_updates"
    if bf16_in:
        spd = np.asarray(jnp.asarray(spd).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    r_want, d_want = jax_cholesky_rt_dinv(
        jnp.asarray(spd).astype(jnp.bfloat16 if bf16_in else jnp.float32),
        nb=32, b_tile=b, interpret=True, bf16_updates=upd)
    a_t = torch.tensor(spd).to(torch.bfloat16 if bf16_in else torch.float32)
    r, d = cholesky_rt_dinv_plain(a_t, bf16_updates=upd)
    assert torch.equal(r, cholesky_rt_plain(a_t, bf16_updates=upd))
    r_want, d_want = np.asarray(r_want), np.asarray(d_want)
    scale = np.abs(r_want).max()
    np.testing.assert_allclose(r.numpy(), r_want, atol=1e-5 * scale)
    assert d.shape == d_want.shape == (b, -(-n // 128), 128, 128)
    assert _inv_times_d_err(r.numpy(), d.numpy()) <= 5e-5
    tol = 2e-3 if upd else 1e-6
    np.testing.assert_allclose(d.numpy(), d_want,
                               atol=tol * np.abs(d_want).max())


def test_dinv_pad_blocks_are_identity():
    spd = _spd(np.random.default_rng(3), 2, 150)
    _, d = cholesky_rt_dinv_plain(torch.tensor(spd))
    pad = d[:, 1, 22:, :]
    assert torch.equal(pad[:, :, 22:], torch.eye(106).expand(2, 106, 106))
    assert torch.all(pad[:, :, :22] == 0) and torch.all(d[:, 1, :22, 22:] == 0)


def test_diag_block_inverses_match_library_inverse():
    """The plain inversion against torch.linalg.solve_triangular of each
    padded block against I (float64): f32 round-off of a back-substitution
    over <= 128 rows of a well-conditioned triangle."""
    r = cholesky_rt_plain(torch.tensor(_spd_occupancy(
        np.random.default_rng(4), 3, 150)))
    rp = torch.tensor(_padded(r.numpy()), dtype=torch.float64)
    want = torch.stack([torch.linalg.solve_triangular(
        rp[:, i:i + 128, i:i + 128], torch.eye(128, dtype=torch.float64)
        .expand(3, 128, 128), upper=True) for i in (0, 128)], 1).mT
    got = diag_block_inverses_t(r).to(torch.float64)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.parametrize("b,n", [(3, 40), (5, 150), (2, 1)])
@pytest.mark.parametrize("kind", ["dominant", "occupancy"])
def test_chol_solve_plain_matches_jax_kernel_and_f64(b, n, kind):
    """JAX's bar (tests/test_pallas.py:214) against float64, and the same
    against JAX's kernel: both are f32 Cholesky solves."""
    rng = np.random.default_rng(n + 11)
    spd = (_spd if kind == "dominant" else _spd_occupancy)(rng, b, n)
    v = rng.standard_normal((b, n)).astype(np.float32)
    want = np.asarray(jax_chol_solve(jnp.asarray(spd), jnp.asarray(v),
                                     b_tile=b, interpret=True))
    got = chol_solve_plain(torch.tensor(spd), torch.tensor(v)).numpy()
    f64 = np.linalg.solve(spd.astype(np.float64),
                          v.astype(np.float64)[..., None])[..., 0]
    assert got.dtype == np.float32 and got.shape == (b, n)
    np.testing.assert_allclose(got, f64, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_wrappers_run_plain_on_cpu_and_check_operands():
    spd = torch.tensor(_spd(np.random.default_rng(5), 2, 40))
    v = torch.ones(2, 40)
    for w in (cholesky_rt_dinv, chol_solve):
        w.reset_counts()
    r, d = cholesky_rt_dinv(spd)
    x = chol_solve(spd, v)
    assert (cholesky_rt_dinv.plain_calls, cholesky_rt_dinv.launches) == (1, 0)
    assert (chol_solve.plain_calls, chol_solve.launches) == (1, 0)
    assert r.shape == (2, 40, 40) and d.shape == (2, 1, 128, 128)
    np.testing.assert_allclose((spd @ x[..., None])[..., 0].numpy(),
                               v.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        cholesky_rt_dinv(torch.zeros(3, 4, 5))
    with pytest.raises(TypeError):
        chol_solve(spd.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        chol_solve(spd, torch.ones(2, 41))


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("n", [150, 300])
def test_triangular_solve_vec_dinv_path_matches_jax(n, transpose_a):
    """Mirror of tests/test_pallas.py:281: the dinv_t block substitution
    against JAX's on the same factor and dinv_t (f32 matvecs in another
    grouping), and against the port's solve_triangular path."""
    rng = np.random.default_rng(n)
    spd = _spd(rng, 3, n) + 30.0 * np.eye(n, dtype=np.float32)
    r, d = cholesky_rt_dinv_plain(torch.tensor(spd))
    v = rng.standard_normal((3, n)).astype(np.float32)
    want = np.asarray(jax_tsv(jnp.asarray(r.numpy()), jnp.asarray(v),
                              lower=False, transpose_a=transpose_a, m=128,
                              dinv_t=jnp.asarray(d.numpy())))
    got = triangular_solve_vec(r, torch.tensor(v), lower=False,
                               transpose_a=transpose_a, m=128, dinv_t=d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    lib = triangular_solve_vec(r, torch.tensor(v), lower=False,
                               transpose_a=transpose_a)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        triangular_solve_vec(r, torch.tensor(v), lower=False,
                             dinv_t=d[:, :1])


@pytest.mark.parametrize("lower", [False, True])
def test_triangular_solve_vec_dinv_path_lower_factor(lower):
    """Both storage orientations, both op orientations, against JAX."""
    rng = np.random.default_rng(7)
    fac = np.tril(rng.standard_normal((2, 150, 150)).astype(np.float32)
                  * 0.05) + 2.0 * np.eye(150, dtype=np.float32)
    if not lower:
        fac = fac.transpose(0, 2, 1).copy()
    rp = torch.tensor(_padded(fac))
    d = torch.stack([torch.linalg.inv(rp[:, i:i + 128, i:i + 128]).mT
                     for i in (0, 128)], 1)
    v = rng.standard_normal((2, 150)).astype(np.float32)
    for ta in (False, True):
        want = np.asarray(jax_tsv(jnp.asarray(fac), jnp.asarray(v),
                                  lower=lower, transpose_a=ta, m=128,
                                  dinv_t=jnp.asarray(d.numpy())))
        got = triangular_solve_vec(torch.tensor(fac), torch.tensor(v),
                                   lower=lower, transpose_a=ta, m=128,
                                   dinv_t=d).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("solver", sorted(JAX_SOLVER_ENV))
@pytest.mark.parametrize("l_dtype", ["f32", "bf16"])
def test_spd_solve_value_and_grad_match_jax(monkeypatch, solver, l_dtype):
    """Mirror of tests/test_pallas.py:164 and tests/test_spd_solve.py:94:
    spd_solve's value and IFT gradients under each solver against JAX's
    spd_solve under the matching SG_CHOL_* settings (a bf16 L is the same
    bf16 matrix on both sides; its cotangent comes back bf16).  One plain
    kernel call per forward; the backward reuses the factor (0 more) or,
    for chol_solve, solves once more (1)."""
    rng = np.random.default_rng(1)
    b, n = 3, 150
    l_mat = _spd(rng, b, n) * 10.0
    rhs = rng.standard_normal((b, n)).astype(np.float32)
    w = rng.standard_normal((b, n)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if l_dtype == "bf16"
                else (jnp.float32, torch.float32))
    _jax_env(monkeypatch, solver, b)

    def jloss(lm, r):
        return jnp.sum(jnp.sin(jax_spd_solve(lm, r)) * w)

    jl = jnp.asarray(l_mat).astype(jdt)
    want = np.asarray(jax_spd_solve(jl, jnp.asarray(rhs)))
    gl_want, gr_want = jax.grad(jloss, argnums=(0, 1))(jl, jnp.asarray(rhs))
    lm = torch.tensor(np.asarray(jl.astype(jnp.float32))).to(tdt)
    lm.requires_grad_(True)
    r = torch.tensor(rhs, requires_grad=True)
    wrapper = {"cholesky_rt": cholesky_rt, "cholesky_rt_dinv":
               cholesky_rt_dinv, "chol_solve": chol_solve}[solver]
    for k in (cholesky_rt, cholesky_rt_dinv, chol_solve):
        k.reset_counts()
    x = spd_solve(lm, r, solver=solver)
    assert wrapper.plain_calls == 1
    (torch.sin(x) * torch.tensor(w)).sum().backward()
    assert wrapper.plain_calls == (2 if solver == "chol_solve" else 1)
    assert (cholesky_rt.plain_calls + cholesky_rt_dinv.plain_calls
            + chol_solve.plain_calls) == wrapper.plain_calls
    assert lm.grad.dtype == tdt
    np.testing.assert_allclose(x.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(lm.grad.float().numpy(),
                               np.asarray(gl_want.astype(jnp.float32)),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr_want),
                               rtol=1e-3, atol=1e-4)


def test_spd_solve_solvers_agree_and_reject_unknown():
    """The three solvers compute one function: f32 solves of the same
    matrix (condition ~1e2) to 1e-5 of each other."""
    rng = np.random.default_rng(2)
    l_mat = torch.tensor(_spd_occupancy(rng, 2, 150))
    rhs = torch.tensor(rng.standard_normal((2, 150)).astype(np.float32))
    xs = [spd_solve(l_mat, rhs, solver=s) for s in sorted(JAX_SOLVER_ENV)]
    for x in xs[1:]:
        np.testing.assert_allclose(x.numpy(), xs[0].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(xs[0].abs().max()))
    with pytest.raises(ValueError):
        spd_solve(l_mat, rhs, solver="lapack")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,dtype,upd,kind", [
    (64, 600, torch.float32, False, "dominant"),
    (64, 600, torch.bfloat16, False, "dominant"),
    (64, 600, torch.float32, True, "dominant"),
    (64, 600, torch.float32, False, "occupancy"),
    (3, 129, torch.float32, False, "dominant"),
    (2, 256, torch.float32, False, "occupancy"),
    (2, 1, torch.float32, False, "dominant"),
    (1, 600, torch.float32, False, "dominant"),
    (2, 617, torch.float32, False, "dominant"),
    (1, MAX_N, torch.float32, False, "dominant")])
def test_cuda_dinv_kernel_matches_plain(b, n, dtype, upd, kind):
    """R bit-identical to the cholesky_rt kernel's; dinv_t inverts R's
    blocks to 5e-5 and equals the plain inversion of the kernel's own R to
    1e-5 of its scale (f32 sums of up to 128 products in another order)."""
    _cuda()
    make = _spd if kind == "dominant" else _spd_occupancy
    spd = torch.tensor(make(np.random.default_rng(n), b, n),
                       device="cuda").to(dtype)
    cholesky_rt_dinv.reset_counts()
    r, d = cholesky_rt_dinv(spd, bf16_updates=upd)
    torch.cuda.synchronize()
    assert cholesky_rt_dinv.launches == 1
    assert torch.equal(r, cholesky_rt(spd, bf16_updates=upd))
    assert _inv_times_d_err(r.cpu().numpy(), d.cpu().numpy()) <= 5e-5
    want = diag_block_inverses_t(r)
    assert float((d - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,kind", [(64, 600, "dominant"),
                                      (64, 600, "occupancy"),
                                      (3, 129, "dominant"),
                                      (2, 1, "dominant"),
                                      (1, 600, "dominant"),
                                      (2, 617, "dominant"),
                                      (1, MAX_N, "dominant")])
def test_cuda_chol_solve_kernel_matches_plain(b, n, kind):
    """x against the plain version (1e-5 of max |x|: f32 sums in another
    order in the updates and the back-substitution's matvecs) and against
    float64 at JAX's bar."""
    _cuda()
    rng = np.random.default_rng(n)
    spd = (_spd if kind == "dominant" else _spd_occupancy)(rng, b, n)
    v = rng.standard_normal((b, n)).astype(np.float32)
    a_t, v_t = torch.tensor(spd, device="cuda"), torch.tensor(v,
                                                              device="cuda")
    chol_solve.reset_counts()
    x = chol_solve(a_t, v_t)
    torch.cuda.synchronize()
    assert chol_solve.launches == 1
    want = chol_solve_plain(a_t, v_t)
    assert float((x - want).abs().max() / want.abs().max()) <= 1e-5
    f64 = np.linalg.solve(spd.astype(np.float64),
                          v.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x.cpu().numpy(), f64, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernels_reject_n_above_limit():
    _cuda()
    a = torch.eye(MAX_N + 1, device="cuda")[None]
    for w in (cholesky_rt_dinv, chol_solve):
        w.reset_counts()
    with pytest.raises(ValueError, match=str(MAX_N)):
        cholesky_rt_dinv(a)
    with pytest.raises(ValueError, match=str(MAX_N)):
        chol_solve(a, torch.ones(1, MAX_N + 1, device="cuda"))
    for w in (cholesky_rt_dinv, chol_solve):
        assert (w.launches, w.plain_calls) == (0, 0)
