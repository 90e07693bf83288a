"""The port's imperceptibility metrics (speakerguard_tpu_torch/metrics/)
against the JAX package's (speakerguard_tpu/metrics/), the goldens, and the
cases of tests/test_data_metrics.py and tests/test_metric_golden.py.

Both packages run the same float64 numpy code on the host, so the port's
values are held to JAX's within 1e-12 relative; the goldens at
tests/test_metric_golden.py's own bars (1e-6 for the native pins).
"""

import os
import sys

import numpy as np
import pytest

from speakerguard_tpu.metrics import metric as JM
from speakerguard_tpu.metrics.pesq_native import pesq_wb as jax_pesq_wb

from speakerguard_tpu_torch.metrics import metric as M
from speakerguard_tpu_torch.metrics import pesq_native
from speakerguard_tpu_torch.metrics.pesq_native import pesq_wb

from test_torch_kenan import one_cpu_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "metric_golden.npz")


@pytest.fixture(scope="module")
def pair():
    """A speech-like 2 s wave and an adversarial-style copy (uniform
    perturbation within 0.002), in the scale domain."""
    t = np.arange(32000) / 16000.0
    x = ((0.25 * np.sin(2 * np.pi * 220 * t)
          + 0.12 * np.sin(2 * np.pi * 440 * t)
          + 0.06 * np.sin(2 * np.pi * 1800 * t))
         * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    p = np.random.default_rng(5).uniform(-0.002, 0.002, len(x))
    return x, (x + p).astype(np.float32)


@pytest.mark.parametrize("name", ["L2", "L0", "L1", "Linf", "SNR", "STOI",
                                  "PESQ"])
def test_metric_matches_jax(pair, name):
    b, a = pair
    want = getattr(JM, name)(b, a)
    got = getattr(M, name)(b, a)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("domain", ["scale", "origin"])
def test_get_all_metric_matches_jax(pair, domain):
    """[L2, L0, L1, Linf, SNR, PESQ, STOI], on scale-domain input and on
    int16-valued input (preprocess rescales it)."""
    b, a = pair
    if domain == "origin":
        b, a = np.round(b * 32768), np.round(a * 32768)
    want = JM.get_all_metric(b, a)
    got = M.get_all_metric(b, a)
    assert len(got) == 7
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_identical_waves_match_jax(pair):
    b, _ = pair
    assert M.SNR(b, b) == JM.SNR(b, b) == np.inf
    assert M.get_all_metric(b, b)[:4] == JM.get_all_metric(b, b)[:4]


@pytest.fixture(scope="module")
def golden():
    assert os.path.exists(GOLDEN)
    return np.load(GOLDEN, allow_pickle=False)


def test_pesq_golden_values(golden):
    """tests/test_metric_golden.py::test_pesq_golden_values on the port."""
    ref = golden["ref"]
    tol = 0.1 if str(golden["pesq_source"]) == "certified" else 1e-6
    for name, want in zip(golden["names"], golden["pesq"]):
        got = pesq_wb(ref, golden[f"deg_{name}"])
        assert abs(got - want) < tol, (name, got, want)
        assert got == jax_pesq_wb(ref, golden[f"deg_{name}"])


def test_stoi_golden_values(golden):
    """tests/test_metric_golden.py::test_stoi_golden_values on the port."""
    ref = golden["ref"]
    tol = 0.02 if str(golden["stoi_source"]) == "certified" else 1e-6
    for name, want in zip(golden["names"], golden["stoi"]):
        got = M.STOI(ref, golden[f"deg_{name}"], fs=16000)
        assert abs(got - want) < tol, (name, got, want)


def test_pesq_identical_is_wideband_ceiling(golden):
    np.testing.assert_allclose(pesq_wb(golden["ref"], golden["ref"]),
                               4.6438887, atol=1e-4)


def test_pesq_monotone_in_snr(golden):
    ref = golden["ref"]
    vals = [pesq_wb(ref, golden[f"deg_awgn_{s}db"]) for s in (40, 30, 20, 10)]
    assert all(a > b for a, b in zip(vals, vals[1:])), vals


# the cases of tests/test_data_metrics.py:62-135, on the port

def test_lp_metrics(rng):
    b = rng.standard_normal(8000).astype(np.float32) * 0.1
    a = b.copy()
    a[:100] += 0.01
    assert M.L0(b, a) == 100
    np.testing.assert_allclose(M.L1(b, a), 1.0, rtol=1e-4)
    np.testing.assert_allclose(M.Linf(b, a), 0.01, rtol=1e-4)
    np.testing.assert_allclose(M.L2(b, a), 0.1, rtol=1e-4)
    assert M.SNR(b, b) == np.inf


def test_snr(rng):
    b = rng.standard_normal(8000).astype(np.float32) * 0.1
    noise = rng.standard_normal(8000).astype(np.float32) * 0.01
    snr = M.SNR(b, b + noise)
    want = 10 * np.log10((b ** 2).sum() / (noise ** 2).sum())
    np.testing.assert_allclose(snr, want, rtol=1e-5)


def test_stoi_properties(rng):
    t = np.arange(32000) / 16000
    x = (np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.3 * np.sin(2 * np.pi * 800 * t)).astype(np.float32) * 0.3
    same = M.STOI(x, x)
    assert same > 0.99
    noisy = x + rng.standard_normal(len(x)).astype(np.float32) * 0.3
    lower = M.STOI(x, noisy)
    assert lower < same
    worse = x + rng.standard_normal(len(x)).astype(np.float32) * 1.0
    assert M.STOI(x, worse) < lower


def test_get_all_metric(rng):
    b = rng.standard_normal(32000).astype(np.float32) * 0.1
    a = b + rng.standard_normal(32000).astype(np.float32) * 0.001
    out = M.get_all_metric(b, a)
    assert len(out) == 7
    l2, l0, l1, linf, snr, pesq, stoi = out
    assert l0 > 0 and snr > 20
    assert isinstance(pesq, float) and 1.0 <= pesq <= 4.644  # native PESQ


def test_native_pesq_properties(rng):
    t = np.arange(48000) / 16000.0
    x = ((0.25 * np.sin(2 * np.pi * 220 * t)
          + 0.12 * np.sin(2 * np.pi * 440 * t)
          + 0.06 * np.sin(2 * np.pi * 1800 * t))
         * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)))
    np.testing.assert_allclose(pesq_wb(x, x), 4.6438887, atol=1e-4)
    scores = []
    for snr_db in (40, 30, 20, 10):
        n = rng.standard_normal(len(x))
        n *= np.sqrt((x ** 2).mean() / (n ** 2).mean() / 10 ** (snr_db / 10))
        scores.append(pesq_wb(x, x + n))
    assert all(a > b for a, b in zip(scores, scores[1:]))
    assert scores[0] > 4.0 and scores[-1] < 2.0
    p = rng.uniform(-0.002, 0.002, len(x))
    assert pesq_wb(x, x + p) > 3.0
    n = np.sin(2 * np.pi * 1234.5 * t) * 0.01
    np.testing.assert_allclose(pesq_wb(x, x + n), pesq_wb(x, x + n))
    assert 1.0 <= pesq_wb(x, x + n) <= 4.644


def test_pesq_falls_back_to_the_ports_native(pair, monkeypatch):
    """Without the compiled pesq package, PESQ reaches the port's
    pesq_wb, with speakerguard_tpu blocked from import."""
    b, a = pair
    for mod in ("pesq", "speakerguard_tpu", "speakerguard_tpu.metrics",
                "speakerguard_tpu.metrics.pesq_native"):
        monkeypatch.setitem(sys.modules, mod, None)
    calls = []
    orig = pesq_native.pesq_wb
    monkeypatch.setattr(pesq_native, "pesq_wb",
                        lambda *args: calls.append(1) or orig(*args))
    got = M.PESQ(b, a)
    assert calls == [1]
    assert got == orig(M.preprocess(b), M.preprocess(a))
