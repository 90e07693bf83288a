"""The port's defenses, BPDA, resampling, FIR filtering and k-means against
the JAX package (speakerguard_tpu/defenses, adaptive/bpda.py, ops/resample.py,
ops/iir.py, ops/kmeans.py), on the same numpy inputs, with the JAX-drawn
random values passed in (AT's noise, k-means' initial frames, warped
k-means' seed).

Bars: QT/BDR values equal (powers of two scale and quantise exactly) and
the straight-through gradient exactly 1; the float32 convolutions (AS, DS,
LPF, BPF, apply_fir) within rtol 1e-5 / atol 1e-6 of JAX's (sums in
another order); MS equal; k-means outputs and VJPs within rtol 1e-5 /
atol 1e-5 with identical assignments; lfilter against scipy at rtol 1e-3 /
atol 1e-4 (the truncated tail and float32 recurrences), as the JAX package's
own test holds it.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.adaptive.bpda import bpda as jax_bpda
from speakerguard_tpu.defenses import feature_level as JFL
from speakerguard_tpu.defenses import frequency_domain as JFD
from speakerguard_tpu.defenses import time_domain as JTD
from speakerguard_tpu.defenses.registry import (
    lambda_defense as jax_lambda_defense, parser_defense as jax_parser)
from speakerguard_tpu.ops import iir as jiir
from speakerguard_tpu.ops import kmeans as jkm
from speakerguard_tpu.ops.resample import resample as jax_resample

from speakerguard_tpu_torch.adaptive.bpda import bpda
from speakerguard_tpu_torch.defenses import feature_level as FL
from speakerguard_tpu_torch.defenses import frequency_domain as FD
from speakerguard_tpu_torch.defenses import speech_compression as SC
from speakerguard_tpu_torch.defenses import time_domain as TD
from speakerguard_tpu_torch.defenses.registry import (
    CODECS, INPUT_TRANSFORMATIONS, lambda_defense, parser_defense)
from speakerguard_tpu_torch.ops import iir
from speakerguard_tpu_torch.ops import kmeans as km
from speakerguard_tpu_torch.ops.resample import resample

from test_torch_speech_compression import fake_ffmpeg  # noqa: F401

CONV_TOL = dict(rtol=1e-5, atol=1e-6)
KM_TOL = dict(rtol=1e-5, atol=1e-5)


def _wave(seed, shape=(3, 1600), scale=0.5):
    return (np.random.default_rng(seed).uniform(-1, 1, shape) * scale
            ).astype(np.float32)


def _both(jax_fn, fn, x, **kw):
    return (np.asarray(jax_fn(jnp.asarray(x), **kw)),
            fn(torch.tensor(x), **kw).numpy())


# ---- time domain -----------------------------------------------------------

@pytest.mark.parametrize("param", [128, 512])
@pytest.mark.parametrize("domain", ["scale", "origin"])
def test_qt_matches_jax_with_identity_gradient(param, domain):
    x = _wave(1) * (32768.0 if domain == "origin" else 1.0)
    want, got = _both(JTD.QT, TD.QT, x, param=param)
    np.testing.assert_array_equal(got, want)
    xt = torch.tensor(x, requires_grad=True)
    TD.QT(xt, param=param).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_qt_rounds_half_to_even_as_jax():
    # k + 0.5 quanta exactly: round half to even in both
    x = (np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 3.5]]) * 512 / 32768
         ).astype(np.float32)
    want, got = _both(JTD.QT, TD.QT, x, param=512)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got * 32768 / 512,
                                  [[0, 2, 2, 0, -2, 4]])


@pytest.mark.parametrize("param", [4, 8])
def test_bdr_matches_jax(param):
    want, got = _both(JTD.BDR, TD.BDR, _wave(2), param=param)
    np.testing.assert_array_equal(got, want)


def test_at_with_the_jax_noise_passed_in():
    x = _wave(3, (2, 4000))
    key = jax.random.PRNGKey(7)
    want = np.asarray(JTD.AT(jnp.asarray(x), param=20.0, rng=key))
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    seen = []

    def draw(kind, shape):
        seen.append((kind, shape))
        return noise

    got = TD.AT(torch.tensor(x), param=20.0, draw=draw).numpy()
    assert seen == [("at_noise", x.shape)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="stochastic"):
        TD.AT(torch.tensor(x))


def test_at_from_a_generator_hits_the_snr():
    x = torch.tensor(_wave(4, (1, 16000)))
    y = TD.AT(x, param=25.0,
              draw=TD.generator_draw(torch.Generator().manual_seed(0)))
    snr = 10 * torch.log10((x ** 2).sum() / ((y - x) ** 2).sum())
    assert abs(float(snr) - 25.0) < 1.0


@pytest.mark.parametrize("param", [3, 5])
def test_as_matches_jax(param):
    want, got = _both(JTD.AS, TD.AS, _wave(5), param=param)
    np.testing.assert_allclose(got, want, **CONV_TOL)


@pytest.mark.parametrize("param", [3, 7])
def test_ms_odd_window_matches_jax(param):
    want, got = _both(JTD.MS, TD.MS, _wave(6), param=param)
    np.testing.assert_array_equal(got, want)


def test_ms_even_window_raises_as_jax():
    """An even window has no centre: the JAX package's window stack raises
    (its zero pad is one sample short), and the port refuses it."""
    x = _wave(7, (1, 50))
    with pytest.raises(ValueError):
        JTD.MS(jnp.asarray(x), param=4)
    with pytest.raises(ValueError, match="odd"):
        TD.MS(torch.tensor(x), param=4)


@pytest.mark.parametrize("shape", [(1600,), (2, 1600), (2, 1, 1600)])
def test_wave_shapes_are_kept(shape):
    x = _wave(8, shape)
    for jf, f in ((JTD.QT, TD.QT), (JTD.MS, TD.MS), (JFD.DS, FD.DS)):
        want, got = _both(jf, f, x)
        assert got.shape == want.shape == shape
        np.testing.assert_allclose(got, want, **CONV_TOL)


# ---- frequency domain ------------------------------------------------------

@pytest.mark.parametrize("orig,new", [(16000, 8000), (8000, 16000),
                                      (16000, 12000), (16000, 16000)])
def test_resample_matches_jax(orig, new):
    x = _wave(9, (2, 1001))
    want = np.asarray(jax_resample(jnp.asarray(x), orig, new))
    got = resample(torch.tensor(x), orig, new).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **CONV_TOL)


@pytest.mark.parametrize("param", [0.5, 0.25])
def test_ds_matches_jax(param):
    want, got = _both(JFD.DS, FD.DS, _wave(10), param=param)
    np.testing.assert_allclose(got, want, **CONV_TOL)


@pytest.mark.parametrize("domain", ["scale", "origin"])
@pytest.mark.parametrize("name,kw", [("LPF", {}), ("LPF", {"param": 6000}),
                                     ("BPF", {}),
                                     ("BPF", {"param": (100, 6000)})])
def test_filters_match_jax(name, kw, domain):
    x = _wave(11, (2, 3000), 0.99) * (32768.0 if domain == "origin" else 1.0)
    want, got = _both(getattr(JFD, name), getattr(FD, name), x, **kw)
    scale = 32768.0 if domain == "origin" else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_apply_fir_matches_lfilter_scan_and_scipy():
    from scipy import signal as ssig
    b, a = ssig.butter(4, 0.3, btype="low", output="ba")
    x = np.random.default_rng(12).standard_normal((2, 400)).astype(
        np.float32)
    h = iir.fir_from_iir(b, a)
    np.testing.assert_array_equal(h, jiir.fir_from_iir(b, a))
    got = iir.apply_fir(torch.tensor(x), h).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jiir.apply_fir(jnp.asarray(x), h)), **CONV_TOL)
    scan = iir.lfilter_scan(torch.tensor(x), b, a).numpy()
    np.testing.assert_allclose(
        scan, np.asarray(jiir.lfilter_scan(jnp.asarray(x), b, a)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, scan, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, ssig.lfilter(b, a, x, axis=1),
                               rtol=1e-3, atol=1e-4)


# ---- registry --------------------------------------------------------------

REGISTRY_CASES = [
    (["AT", "QT", "FeCo"], ["16", "512", "kmeans 0.2 L2"], [0, 0, 1],
     "sequential"),
    (["QT", "AS", "MS"], ["512", "3", "5"], [0, 0, 0], "average"),
    (["BPF", "DS", "LPF"], ["50 5000", "0.5", "6000"], [0, 0, 0],
     "sequential"),
    (["BDR", "FEATURE_COMPRESSION"], [None, "warped_kmeans 0.5 ts"], [0, 2],
     "sequential"),
    (["QT", "FeCo"], None, [0, 0], "average"),
]


@pytest.mark.parametrize("case", range(len(REGISTRY_CASES)))
def test_registry_names_match_jax(case):
    names, params, flags, order = REGISTRY_CASES[case]
    if params is None and "FeCo" in names:
        params = ["512", "kmeans 0.5 cos"]
    jd, jname = jax_parser(names, params, flags, order)
    d, name = parser_defense(names, params, flags, order)
    assert name == jname
    assert [f for f, _ in d] == [f for f, _ in jd]
    assert [fn.keywords if hasattr(fn, "keywords") else None
            for _, fn in d] == [fn.keywords if hasattr(fn, "keywords")
                                else None for _, fn in jd]


def test_registry_resolves_the_same_functions():
    x = _wave(13, (2, 2000))
    for name, param in (("QT", ["512"]), ("BDR", ["8"]), ("AS", ["5"]),
                        ("MS", ["3"]), ("DS", ["0.5"]), ("LPF", ["6000"]),
                        ("BPF", ["100", "6000"]), ("QT", None)):
        want = np.asarray(jax_lambda_defense(name, param)(jnp.asarray(x)))
        got = lambda_defense(name, param)(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, want, **CONV_TOL, err_msg=name)
    assert lambda_defense(None, None)(torch.tensor(x)) is not None
    assert parser_defense(None, None, None, "sequential") == (None, None)


@pytest.mark.parametrize("codec", CODECS)
def test_codecs_resolve_like_jax(codec, fake_ffmpeg):
    """Each codec through both registries, with its default parameter as
    the CLI string: the same keywords, and equal outputs (MULAW within
    rtol 1e-6; the ffmpeg ones through the stand-in ffmpeg of
    tests/test_torch_speech_compression.py, where the codecs are pinned to
    JAX)."""
    assert codec in INPUT_TRANSFORMATIONS
    param = [str(SC.DEFAULT_PARAMS[codec])]
    jf, f = jax_lambda_defense(codec, param), lambda_defense(codec, param)
    assert f.keywords == jf.keywords == {"param": SC.DEFAULT_PARAMS[codec]}
    x = _wave(15, (1, 600))
    got, want = f(torch.tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x)))
    if codec == "MULAW":  # log1p and pow differ by an ulp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_unknown_defense_raises():
    with pytest.raises(NotImplementedError, match="Unsupported"):
        lambda_defense("NOPE", None)


# ---- BPDA ------------------------------------------------------------------

def test_bpda_non_identity_substitute_matches_jax():
    ori = (lambda x: torch.round(x * 4) / 4, lambda x: jnp.round(x * 4) / 4)
    sub = (lambda x: torch.sin(x) * 3, lambda x: jnp.sin(x) * 3)
    x = _wave(14, (5,), 2.0)
    jf = jax_bpda(ori[1], sub[1])
    want_y = np.asarray(jf(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) ** 2))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = bpda(ori[0], sub[0])(xt)
    (y ** 2).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-6)


def test_bpda_passes_extra_args_to_both():
    f = bpda(lambda x, s: torch.round(x * s), lambda x, s: x * s)
    xt = torch.tensor([0.26, 0.74], requires_grad=True)
    y = f(xt, 4.0)
    y.sum().backward()
    assert y.tolist() == [1.0, 3.0] and xt.grad.tolist() == [4.0, 4.0]


# ---- k-means ---------------------------------------------------------------

def _jax_init_indices(key, b, t, k):
    return np.array(jax.vmap(lambda kk: jax.random.permutation(kk, t)[:k])(
        jax.random.split(key, b)))


def _feat(seed, shape=(3, 40, 6)):
    return (np.random.default_rng(seed).standard_normal(shape) * 4
            ).astype(np.float32)


@pytest.mark.parametrize("distance", ["L2", "cos"])
@pytest.mark.parametrize("ratio", [0.5, 0.2])
def test_kmeans_output_and_vjp_match_jax(distance, ratio):
    feat = _feat(15)
    b, t, f = feat.shape
    k = int(t * ratio)
    key = jax.random.PRNGKey(3)
    idx = _jax_init_indices(key, b, t, k)
    cot = np.random.default_rng(16).standard_normal((b, k, f)).astype(
        np.float32)

    def jfn(v):
        return jkm.kmeans_compress_batch(v, ratio, key, distance=distance)

    want, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(feat))
    (want_g,) = vjp(jnp.asarray(cot))
    ft = torch.tensor(feat, requires_grad=True)
    got = km.kmeans_compress_batch(ft, ratio, init_idx=idx,
                                   distance=distance)
    (got * torch.tensor(cot)).sum().backward()
    assert got.shape == (b, k, f)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **KM_TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g),
                               **KM_TOL)


def test_kmeans_empty_clusters_fall_back_as_jax():
    """Repeated frames: centres drawn on copies of one frame leave all but
    the first of them empty, so both fallbacks (the current centre in the
    loop, the live frame feat[:, i] in the recompute) are taken."""
    base = _feat(17, (1, 6, 4))
    feat = np.repeat(base, 5, axis=1)                  # (1, 30, 4)
    key = jax.random.PRNGKey(11)
    idx = _jax_init_indices(key, 1, 30, 15)
    want, vjp = jax.vjp(lambda v: jkm.kmeans_compress_batch(v, 0.5, key),
                        jnp.asarray(feat))
    (want_g,) = vjp(jnp.ones(want.shape, jnp.float32))
    ft = torch.tensor(feat, requires_grad=True)
    got = km.kmeans_compress_batch(ft, 0.5, init_idx=idx)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **KM_TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g),
                               **KM_TOL)
    # some cluster came back as a live frame of feat[:, :15]
    assert np.any(np.all(np.isin(got.detach().numpy()[0], feat[0, :15]),
                         axis=-1))


def test_feco_draw_fn_supplies_the_jax_initial_frames():
    feat = _feat(18)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JFL.FeCo(jnp.asarray(feat), "kmeans", 0.5, "L2",
                               rng=key))
    seen = []

    def draw(kind, shape):
        seen.append((kind, shape))
        return _jax_init_indices(key, *shape, shape[1])

    got = FL.FeCo(torch.tensor(feat), "kmeans", 0.5, "L2", draw=draw)
    assert seen == [("kmeans_init", (3, 40))]
    np.testing.assert_allclose(got.numpy(), want, **KM_TOL)
    # no key: JAX's PRNGKey(0) fallback
    want0 = np.asarray(JFL.FeCo(jnp.asarray(feat), "kmeans", 0.5, "L2"))
    got0 = FL.FeCo(torch.tensor(feat), "kmeans", 0.5, "L2",
                   draw=lambda kind, shape: _jax_init_indices(
                       jax.random.PRNGKey(0), *shape, shape[1]))
    np.testing.assert_allclose(got0.numpy(), want0, **KM_TOL)


def test_feco_generator_draws_distinct_frames_per_row():
    feat = torch.tensor(_feat(19))
    idx = km.initial_indices(3, 40, 20, torch.Generator().manual_seed(4))
    assert idx.shape == (3, 20)
    assert all(len(set(r.tolist())) == 20 for r in idx)
    a = FL.FeCo(feat,
                draw=TD.generator_draw(torch.Generator().manual_seed(4)))
    b = km.kmeans_compress_batch(feat, 0.5, init_idx=idx)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # no draw: seed 0, the same every call
    torch.testing.assert_close(FL.FeCo(feat), FL.FeCo(feat), rtol=0, atol=0)


@pytest.mark.parametrize("init", ["ts", "random"])
def test_warped_kmeans_matches_jax(init):
    feat = _feat(20, (2, 30, 4))
    key = jax.random.PRNGKey(9)
    want, vjp = jax.vjp(lambda v: JFL.FeCo(v, "warped_kmeans", 0.5, init,
                                           rng=key), jnp.asarray(feat))
    (want_g,) = vjp(jnp.ones(want.shape, jnp.float32))
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    ft = torch.tensor(feat, requires_grad=True)
    got = FL.FeCo(ft, "warped_kmeans", 0.5, init,
                  draw=lambda kind, shape: seed)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **KM_TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g),
                               **KM_TOL)
