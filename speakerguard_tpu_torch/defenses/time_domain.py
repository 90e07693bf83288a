"""Time-domain input transformation defenses.

Port of speakerguard_tpu/defenses/time_domain.py (reference
defense/time_domain.py).  Every defense is a function ``f(audio, draw=None)
-> audio`` over (B, L) (or (L,), (B, 1, L)); QT and BDR are BPDA-wrapped
with an identity substitute (straight-through), as the reference wraps
QT_Non_Diff.

Randomness: a stochastic defense takes its values from ``draw(kind,
shape)``: ``generator_draw`` builds one over a ``torch.Generator``, and
the CPU tests pass one that hands out the JAX-drawn values.  AT's kind is
``"at_noise"``, standard normal of shape (B, L).
"""

import functools
import math

import torch
import torch.nn.functional as F

from speakerguard_tpu_torch.adaptive.bpda import bpda
from speakerguard_tpu_torch.utils.ranges import ABS_MAX


def generator_draw(gen):
    """The draw function over the torch.Generator ``gen`` (None for None):
    ``draw(kind, shape)`` with kind "kmeans_init" gives (B, T) a random
    order of the T frames of each row (one device call for the batch),
    "at_noise" (B, L) standard normal, and "wk_seed" () an int seed."""
    if gen is None:
        return None

    def draw(kind, shape):
        if kind == "kmeans_init":
            return torch.argsort(torch.rand(shape, generator=gen,
                                            device=gen.device), dim=1)
        if kind == "at_noise":
            return torch.randn(shape, generator=gen, device=gen.device)
        if kind == "wk_seed":
            return int(torch.randint(0, 2 ** 31 - 1, shape, generator=gen,
                                     device=gen.device))
        raise ValueError(f"unknown draw kind {kind!r}")
    return draw


def _flatten_wav(audio):
    """Accept (T,), (B, T) or (B, 1, T); return ((B, T), restore_fn)."""
    shape = audio.shape
    if audio.ndim == 1:
        x = audio[None, :]
    elif audio.ndim == 3:
        x = audio[:, 0, :]
    else:
        x = audio
    return x, lambda y: y.reshape(shape)


def _is_scale(x):
    """The 0.9-margin domain rule over the whole batch (one decision)."""
    return torch.logical_and(0.9 * torch.max(x) <= 1.0,
                             0.9 * torch.min(x) >= -1.0)


def QT_Non_Diff(audio, param: int = 128, bits: int = 16):
    """Quantization: round to the nearest multiple of q in the int16 domain
    (reference time_domain.py:10-42); ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    x, restore = _flatten_wav(audio)
    scale = torch.where(_is_scale(x), x.new_tensor(ABS_MAX),
                        x.new_tensor(1.0))
    q = float(param)
    out = torch.round(x * scale / q) * q / scale
    return restore(out)


@functools.lru_cache(maxsize=None)
def _qt_ste(param: int, bits: int):
    return bpda(lambda x: QT_Non_Diff(x, param, bits))


def QT(audio, param: int = 128, bits: int = 16, draw=None):
    return _qt_ste(int(param), int(bits))(audio)


def BDR(audio, param: int = 8, bits: int = 16, draw=None):
    """Bit-depth reduction == QT with q = 2^(bits - param)
    (reference time_domain.py:46-48)."""
    return QT(audio, param=2 ** (bits - param), bits=bits)


def AT(audio, param: float = 25.0, draw=None):
    """Additive Gaussian noise at `param` dB SNR (reference
    time_domain.py:50-70).  Stochastic: ``draw`` is required."""
    if draw is None:
        raise ValueError("AT is stochastic: pass draw")
    x, restore = _flatten_wav(audio)
    b, n = x.shape
    snr = 10.0 ** (param / 10.0)
    power_audio = torch.sum((x / math.sqrt(n)) ** 2, dim=1, keepdim=True)
    power_noise = power_audio / snr
    noise = torch.as_tensor(draw("at_noise", (b, n)), dtype=x.dtype,
                            device=x.device)
    return restore(x + noise * torch.sqrt(power_noise))


def AS(audio, param: int = 3, draw=None):
    """Average smoothing: length-`param` moving average, zero-padded
    (reference time_domain.py:72-97)."""
    if param % 2 != 1:
        raise ValueError(f"AS needs an odd window, got {param}")
    x, restore = _flatten_wav(audio)
    w = torch.full((1, 1, param), 1.0 / param, dtype=x.dtype,
                   device=x.device)
    pad = (param - 1) // 2
    return restore(F.conv1d(x[:, None, :], w, padding=pad)[:, 0, :])


def MS(audio, param: int = 3, draw=None):
    """Median smoothing over a centered window, zero pad (reference
    time_domain.py:100-127): the middle of each sorted window.  An even
    window has no centre: the JAX package pads it (param - 1) // 2 on each
    side, one sample short, and its window stack raises; so does this."""
    if param % 2 != 1:
        raise ValueError(f"MS needs an odd window, got {param}")
    x, restore = _flatten_wav(audio)
    pad = (param - 1) // 2
    windows = F.pad(x, (pad, pad)).unfold(1, param, 1)
    return restore(torch.sort(windows, dim=-1).values[..., pad])
