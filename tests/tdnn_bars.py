"""The TDNN blocks' comparison bars, shared by tests/test_torch_tdnn.py
(whose header gives their reasons) and tests/test_torch_tdnn_conv.py; this
module imports no JAX, so card tests may use it."""

import numpy as np

from speakerguard_tpu_torch.ops.tdnn_conv import BN_EPS


def _f32_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def bf16_ulp(a):
    """The spacing of bf16 numbers at |a| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2 ** -126))
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_bf16_block_close(got, want, b, mean, var):
    """The bf16 output bar of tests/test_torch_tdnn.py's header, for a
    block whose bias, BN mean and BN variance are ``b``, ``mean``, ``var``
    (channels last): the conv output is at most (|out| + one ulp) / s +
    |b - mean| in magnitude, the ulp for the output's own rounding."""
    b, mean, var = (np.asarray(a, np.float32) for a in (b, mean, var))
    s = 1.0 / np.sqrt(var + BN_EPS)
    mag = np.maximum(np.abs(got), np.abs(want))
    conv_mag = (mag + bf16_ulp(mag)) / s + np.abs(b - mean)
    tol = (bf16_ulp(mag) + s * bf16_ulp(conv_mag)
           + 1e-5 * np.abs(want).max())
    diff = np.abs(got - want)
    assert np.all(diff <= tol), f"max excess {(diff - tol).max()}"


def assert_within_top_bf16_ulp(got, want, ulps=1):
    """Every entry within ``ulps`` bf16 ulps of the largest entry of
    ``want``."""
    diff = np.abs(got - want).max()
    assert diff <= ulps * bf16_ulp(np.abs(want).max()), f"max diff {diff}"


def assert_bf16_affine_close(got, want, b, a, c):
    """The bf16 output bar of a block whose BN is affine, out = r a + c
    (``ops/tdnn_conv.affine_bn``): as ``assert_bf16_block_close``, the conv
    output at most (|out| + one ulp + |c|) / |a| + |b| in magnitude, so one
    ulp of it moves the output by |a| times that ulp, plus the output's own
    rounding."""
    b, a, c = (np.asarray(v, np.float32) for v in (b, a, c))
    mag = np.maximum(np.abs(got), np.abs(want))
    abs_a = np.maximum(np.abs(a), np.float32(1e-30))
    conv_mag = (mag + bf16_ulp(mag) + np.abs(c)) / abs_a + np.abs(b)
    tol = (bf16_ulp(mag) + abs_a * bf16_ulp(conv_mag)
           + 1e-5 * np.abs(want).max())
    diff = np.abs(got - want)
    assert np.all(diff <= tol), f"max excess {(diff - tol).max()}"
