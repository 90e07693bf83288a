"""The port's AudioNet log-mel frontend against the JAX package's.

The same numpy waves go through ``speakerguard_tpu.ops.logmel`` and
``speakerguard_tpu_torch.ops.logmel``.  On the CPU JAX's Precision.HIGH is
float32, as the port's exact path is.  Bars:

- the Slaney filterbank and the STFT window: equal, element for element;
- log-mel values: rtol 1e-4, atol 1e-3 (dB), the iv and xv feature bar;
- the VJP of a random cotangent: within 1e-4 of the largest entry of JAX's
  (float32 sums of up to 7 overlapping frames in another order);
- the reflect framing's fold VJP: within 1e-6 of the largest entry of
  autograd's gather backward and of JAX's fold, as the Kaldi framing's
  test in test_torch_frontend.py holds it.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speakerguard_tpu.ops import kaldi_mfcc as jax_mfcc
from speakerguard_tpu.ops import logmel as jax_logmel

from speakerguard_tpu_torch.ops import logmel
from speakerguard_tpu_torch.ops.kaldi_mfcc import _Framer, _geometry_index

CFG = logmel.AUDIONET_LOGMEL
SHORTEST = CFG.n_fft // 2 + 2   # the shortest wave that frames: 514


def _wavs(seed, b=2, length=16000, scale=0.4):
    return np.random.default_rng(seed).uniform(
        -scale, scale, (b, length)).astype(np.float32)


def test_slaney_banks_and_window_equal_jax():
    banks = logmel.slaney_mel_banks(CFG)
    assert banks.shape == (32, 513)
    np.testing.assert_array_equal(
        banks, jax_logmel.slaney_mel_banks(jax_logmel.AUDIONET_LOGMEL))
    window = logmel._stft_window(CFG)
    np.testing.assert_array_equal(
        window, jax_logmel._stft_window(jax_logmel.AUDIONET_LOGMEL))
    assert window.shape == (1024,)
    assert not window[:112].any() and not window[-112:].any()
    assert window[112] == 0.0 and window[113] > 0.0   # periodic hann


@pytest.mark.parametrize("length", [16000, 4000, SHORTEST])
def test_logmel_value_and_vjp_match_jax(length):
    wavs = _wavs(3, length=length)
    want = np.asarray(jax_logmel.audionet_logmel(jnp.asarray(wavs)))
    x = torch.tensor(wavs, requires_grad=True)
    got = logmel.audionet_logmel(x)
    assert got.shape == want.shape == (2, 1 + (length - 1) // 160, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-3)
    cot = np.random.default_rng(4).standard_normal(want.shape).astype(
        np.float32)
    (got * torch.tensor(cot)).sum().backward()
    g_want = np.asarray(jax.grad(lambda w: jnp.sum(
        jax_logmel.audionet_logmel(w) * cot))(jnp.asarray(wavs)))
    np.testing.assert_allclose(x.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * np.abs(g_want).max())


def test_logmel_shapes_and_grad():
    """test_frontend.py's log-mel case: T = 1 + (L-1)//hop, and a finite,
    nonzero waveform gradient."""
    wavs = np.random.default_rng(0).standard_normal((2, 16000)).astype(
        np.float32) * 0.1
    x = torch.tensor(wavs, requires_grad=True)
    out = logmel.audionet_logmel(x)
    assert out.shape == (2, 1 + (16000 - 1) // 160, 32)
    out.sum().backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) > 0


@pytest.mark.parametrize("length", [SHORTEST - 1, 300])
def test_too_short_wave_raises(length):
    """Below n_fft//2 + 2 samples a frame would reflect a sample twice.
    JAX's gather raises "wav too short to frame" from some shorter length
    on, and its fold VJP fails on a broadcast from this one on; the port
    raises here in both directions."""
    with pytest.raises(ValueError, match="too short"):
        logmel.audionet_logmel(torch.zeros(1, length))


@pytest.mark.parametrize("length", [4000, SHORTEST - 1, 47999])
def test_reflect_framing_fold_vjp_matches_gather_autograd_and_jax(length):
    """The framer at the log-mel geometry (win 1024, hop 160, pad 512, edge
    "reflect", 7 overlapping chunks) runs its own fold backward, not
    autograd's index backward, and agrees with both that and JAX's fold."""
    wavs = _wavs(5, length=length)
    geometry = (length, 1 + length // 160, 1024, 160, 512)
    x = torch.tensor(wavs, requires_grad=True)
    frames = _Framer.apply(x, geometry, "reflect")
    assert type(frames.grad_fn).__name__ == "_FramerBackward"
    cot = torch.tensor(np.random.default_rng(6).standard_normal(
        tuple(frames.shape)).astype(np.float32))
    (frames * cot).sum().backward()
    x_plain = torch.tensor(wavs, requires_grad=True)
    plain = x_plain[:, _geometry_index(geometry, "reflect", x_plain.device)]
    assert torch.equal(frames, plain)
    (plain * cot).sum().backward()
    jax_frame = jax_mfcc._framer(*geometry, edge="reflect")
    want = np.asarray(jax.grad(lambda w: jnp.sum(
        jax_frame(w) * jnp.asarray(cot.numpy())))(jnp.asarray(wavs)))
    scale = float(x_plain.grad.abs().max())
    np.testing.assert_allclose(x.grad.numpy(), x_plain.grad.numpy(),
                               rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=1e-6 * scale)


def test_fast_dft_is_float32_on_cpu():
    """fast_dft picks bf16 operands on the card only; on the CPU it is the
    exact path, bit for bit, as JAX's DEFAULT precision is there."""
    x = torch.tensor(_wavs(8, length=8000))
    assert torch.equal(logmel.audionet_logmel(x, fast_dft=True),
                       logmel.audionet_logmel(x))
