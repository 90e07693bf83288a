"""fused_loglike's split product (ops/gmm_loglike.py): the three-piece bf16
split of f32 values, the split aug(x) and projection, and the six products
that sum to the f32 loglike, against the plain f32 function and the JAX
package's Pallas kernel in interpret mode.

On the CPU only the plain versions run; the two launches (``aug_split``,
``loglike_split_gemm``) and the composed kernel are held against them on
the card (marked ``cuda``, skipped here, and by chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speakerguard_tpu.models import gmm as G
from speakerguard_tpu.ops.pallas_gmm import fused_loglike_batch

from speakerguard_tpu_torch.models import gmm as TG
from speakerguard_tpu_torch.ops import gmm_loglike as L

# the three pieces carry v's 24-bit significand
SPLIT_REL = 2.0 ** -24


def _gmm(seed, c, d):
    jp = G.random_gmm(np.random.default_rng(seed), c, d)
    return jp, torch.tensor(np.asarray(jp.quad_proj)), torch.tensor(
        np.asarray(jp.gconsts))


def _feats(seed, b, t, d):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _recompose(pieces):
    return sum(p.to(torch.float64) for p in pieces)


def _split_values(case):
    rng = np.random.default_rng(11)
    v = {
        "random": rng.standard_normal(4096) * 10.0,
        "zero": np.array([0.0, -0.0, 0.0]),
        # up to 3e38, below bf16's largest finite value (3.39e38)
        "large": np.concatenate([[1e30, -1e30, 3e38, -3e38],
                                 rng.standard_normal(256) * 1e35]),
        # third piece ~2^-16 |v| stays a normal number: |v| >= 2^-109
        "tiny": np.concatenate([[1e-30, -1e-30, 1e-25],
                                rng.standard_normal(256) * 1e-20]),
        "negative": -np.abs(rng.standard_normal(1024)) * 100.0,
    }[case]
    return torch.tensor(v.astype(np.float32))


@pytest.mark.parametrize("case", ["random", "zero", "large", "tiny",
                                  "negative"])
def test_split3_pieces_are_bf16_and_recompose(case):
    v = _split_values(case)
    a1, a2, a3 = L.split3_plain(v)
    assert a1.dtype == a2.dtype == a3.dtype == torch.bfloat16
    assert torch.equal(a1, v.to(torch.bfloat16))
    err = (_recompose((a1, a2, a3)) - v.to(torch.float64)).abs()
    assert bool((err <= SPLIT_REL * v.to(torch.float64).abs()).all())


def _pieces(m):
    """(R, 3 F_pad) -> the three (R, F_pad) pieces."""
    return m.reshape(m.shape[0], 3, -1).unbind(1)


@pytest.mark.parametrize("d", [6, 10, 72])
def test_augment_split_pads_with_zeros_and_recomposes(d):
    x = torch.tensor(_feats(d, 2, 5, d))
    f = L.aug_dim(d)
    f_pad = L.padded_k(f)
    aug_s = L.augment_split_plain(x)
    assert aug_s.dtype == torch.bfloat16
    assert aug_s.shape == (10, 3 * f_pad) and f_pad % L.K_TILE == 0
    pieces = _pieces(aug_s)
    assert all(bool((p[:, f:] == 0).all()) for p in pieces)
    want = L.augment_plain(x).reshape(10, f).to(torch.float64)
    err = (_recompose(p[:, :f] for p in pieces) - want).abs()
    assert bool((err <= SPLIT_REL * want.abs()).all())


@pytest.mark.parametrize("d", [6, 10, 72])
def test_proj_split_is_kmajor_padded_and_recomposes(d):
    _, qp, _ = _gmm(d, 64, d)
    f = L.aug_dim(d)
    proj_s = L.proj_split_kmajor(qp)
    assert proj_s.dtype == torch.bfloat16
    assert proj_s.shape == (64, 3 * L.padded_k(f)) and proj_s.is_contiguous()
    pieces = _pieces(proj_s)
    assert all(bool((p[:, f:] == 0).all()) for p in pieces)
    want = qp.T.to(torch.float64)
    err = (_recompose(p[:, :f] for p in pieces) - want).abs()
    assert bool((err <= SPLIT_REL * want.abs()).all())


@pytest.mark.parametrize("t,d,c", [(64, 8, 128), (37, 10, 128),
                                   (100, 12, 200)])
def test_loglike_split_plain_matches_plain_and_jax_kernel(t, d, c):
    """The six products summed in the kernel's order against the plain f32
    function and fused_loglike_batch(interpret=True): all f32 sums of F <=
    90 products of O(10) magnitude in other orders (the split's left-out
    terms are ~2^-26 of each product), so 1e-5 relative with an absolute
    floor of 1e-4, the bar of the plain version's own JAX test."""
    jp, qp, gc = _gmm(t, c, d)
    x = _feats(t + 1, 2, t, d)
    xt = torch.tensor(x)
    got = L.loglike_split_plain(L.augment_split_plain(xt),
                                L.proj_split_kmajor(qp), gc)
    got = got.reshape(2, t, c).numpy()
    np.testing.assert_allclose(got, L.fused_loglike_plain(xt, qp, gc).numpy(),
                               rtol=1e-5, atol=1e-4)
    want = np.asarray(fused_loglike_batch(jnp.asarray(x), jp.quad_proj,
                                          jp.gconsts, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_split_pairs_are_the_six_leading_terms_smallest_first():
    """The products a_i b_j with i + j <= 4 (pieces 0, 1, 2), each once,
    ordered by the scale 2^-8 (i + j) of their terms, a1b1 last."""
    pairs = L.SPLIT_PAIRS
    assert sorted(pairs) == sorted((i, j) for i in range(3) for j in range(3)
                                   if i + j <= 2)
    scale = [i + j for i, j in pairs]
    assert scale == sorted(scale, reverse=True) and pairs[-1] == (0, 0)


def _bad_split_operands():
    """(helper, args) pairs the launch helpers must refuse with ValueError:
    a wrong shape, dtype or layout each, and CPU tensors (no fallback)."""
    x = torch.zeros(2, 5, 6)
    aug_s = L.augment_split_plain(x)                      # (10, 192)
    _, qp, gc = _gmm(1, 64, 6)
    proj_s = L.proj_split_kmajor(qp)                      # (64, 192)
    return {
        "aug_split x f64": (L.aug_split, (x.double(),)),
        "aug_split x empty": (L.aug_split, (torch.zeros(0, 6),)),
        "aug_split on the cpu": (L.aug_split, (x,)),
        "gemm augS f32": (L.loglike_split_gemm, (aug_s.float(), proj_s, gc)),
        "gemm width mismatch": (L.loglike_split_gemm,
                                (aug_s[:, :96].contiguous(), proj_s, gc)),
        "gemm width not 3 x 64k": (L.loglike_split_gemm,
                                   (aug_s[:, :96].contiguous(),
                                    proj_s[:, :96].contiguous(), gc)),
        "gemm gconsts (63,)": (L.loglike_split_gemm, (aug_s, proj_s, gc[1:])),
        "gemm gconsts f64": (L.loglike_split_gemm,
                             (aug_s, proj_s, gc.double())),
        "gemm projS strided": (L.loglike_split_gemm,
                               (aug_s, proj_s[::2], gc[::2])),
        "gemm on the cpu": (L.loglike_split_gemm, (aug_s, proj_s, gc)),
    }


@pytest.mark.parametrize("case", [
    "aug_split x f64", "aug_split x empty", "aug_split on the cpu",
    "gemm augS f32", "gemm width mismatch", "gemm width not 3 x 64k",
    "gemm gconsts (63,)", "gemm gconsts f64", "gemm projS strided",
    "gemm on the cpu"])
def test_split_launch_helpers_check_their_operands(case):
    fn, args = _bad_split_operands()[case]
    with pytest.raises(ValueError):
        fn(*args)


# ---------------------------------------------------------------------------
# on the card: each launch and the composed kernel against plain versions
# ---------------------------------------------------------------------------

# an odd C takes the GEMM epilogue's scalar stores
CARD_SHAPES = [(64, 300, 72, 2048), (3, 37, 10, 200), (2, 130, 6, 64),
               (2, 45, 7, 101)]


def _card_inputs(b, t, d, c):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    p = TG.random_gmm(np.random.default_rng(c + d), c, d, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(t)
    return p, torch.randn((b, t, d), generator=g, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,c", CARD_SHAPES)
def test_cuda_aug_split_equals_plain(b, t, d, c):
    """The same roundings in the same order: torch.equal."""
    _, x = _card_inputs(b, t, d, c)
    aug_s = L.aug_split(x)
    torch.cuda.synchronize()
    assert torch.equal(aug_s, L.augment_split_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,c", CARD_SHAPES)
def test_cuda_loglike_split_gemm_matches_plain(b, t, d, c):
    """Exact products summed in another order (tensor cores against f32
    GEMMs): 2e-6 of the largest sum of absolute terms."""
    p, x = _card_inputs(b, t, d, c)
    aug_s = L.augment_split_plain(x)
    proj_s = L.proj_split_kmajor(p.quad_proj)
    got = L.loglike_split_gemm(aug_s, proj_s, p.gconsts)
    torch.cuda.synchronize()
    want = L.loglike_split_plain(aug_s, proj_s, p.gconsts)
    terms = L.loglike_split_plain(aug_s.abs(), proj_s.abs(),
                                  p.gconsts.abs()).max()
    assert float((got - want).abs().max()) <= 2e-6 * float(terms)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,c", CARD_SHAPES)
def test_cuda_loglike_kernel_error_against_float64(b, t, d, c):
    """The kernel's error against a float64 product of the same f32 aug
    values is at most twice the plain f32 product's."""
    p, x = _card_inputs(b, t, d, c)
    L.fused_loglike.reset_counts()
    got = L.fused_loglike(x, p.quad_proj, p.gconsts)
    torch.cuda.synchronize()
    assert L.fused_loglike.launches == 1
    ref = (L.augment_plain(x).double() @ p.quad_proj.double()
           + p.gconsts.double())
    plain = L.fused_loglike_plain(x, p.quad_proj, p.gconsts)
    err = float((got.double() - ref).abs().max())
    assert err <= 2.0 * float((plain.double() - ref).abs().max())
