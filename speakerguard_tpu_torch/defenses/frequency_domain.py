"""Frequency-domain input transformation defenses.

Port of speakerguard_tpu/defenses/frequency_domain.py (reference
defense/frequency_domain.py):
  * DS   — down-up sinc resampling (reference :8-31), one polyphase conv
    each way (ops/resample.py).
  * LPF / BPF — Butterworth filters designed on the host by scipy (static
    params) and applied on the device as a truncated-impulse-response FIR
    convolution (ops/iir.py).
"""

import functools

from scipy import signal as ssig
import torch

from speakerguard_tpu_torch.defenses.time_domain import _flatten_wav, _is_scale
from speakerguard_tpu_torch.ops.iir import apply_fir, fir_from_iir
from speakerguard_tpu_torch.ops.resample import resample
from speakerguard_tpu_torch.utils.ranges import ABS_MAX


def DS(audio, param: float = 0.5, fs: int = 16000, draw=None):
    x, restore = _flatten_wav(audio)
    new_freq = int(fs * param)
    down = resample(x, fs, new_freq)
    up = resample(down, new_freq, fs)
    return restore(up[..., :x.shape[1]])


@functools.lru_cache(maxsize=None)
def _butter_fir(btype: str, wp, ws, gpass: float, gstop: float):
    n, wn = ssig.buttord(wp, ws, gpass, gstop, analog=False)
    b, a = ssig.butter(n, wn, btype=btype, analog=False, output="ba")
    return fir_from_iir(b, a)


def _clip_bounds(x):
    """(lo, hi) of the domain ``x`` lies in, decided over the whole batch:
    [-1, 1] for scale-domain audio, [-ABS_MAX, ABS_MAX - 1] otherwise."""
    is_scale = _is_scale(x)
    hi = torch.where(is_scale, x.new_tensor(1.0), x.new_tensor(ABS_MAX - 1.0))
    lo = torch.where(is_scale, x.new_tensor(-1.0), x.new_tensor(-ABS_MAX))
    return lo, hi


def LPF(audio, param: float = 8000, wp: float = 4000, fs: int = 16000,
        gpass: float = 3, gstop: float = 40, draw=None):
    """Butterworth low-pass: passband wp Hz, stopband `param` Hz
    (reference :33-70)."""
    x, restore = _flatten_wav(audio)
    h = _butter_fir("low", 2 * wp / fs, 2 * param / fs, gpass, gstop)
    y = apply_fir(x, h)
    lo, hi = _clip_bounds(x)
    return restore(torch.clamp(y, lo, hi))


def BPF(audio, param=(50, 5000), wp=(300, 4000), fs: int = 16000,
        gpass: float = 3, gstop: float = 40, draw=None):
    """Butterworth band-pass (reference :72-112)."""
    x, restore = _flatten_wav(audio)
    h = _butter_fir("bandpass",
                    tuple(2 * w / fs for w in wp),
                    tuple(2 * s / fs for s in param), gpass, gstop)
    y = apply_fir(x, h)
    lo, hi = _clip_bounds(x)
    return restore(torch.clamp(y, lo, hi))
