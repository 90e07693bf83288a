"""AudioNet log-mel frontend, batched over (B, L) waveforms.

Port of speakerguard_tpu/ops/logmel.py (reference model/_audionet/
Preprocessor.py:48-112): preemphasis 0.97 -> STFT (n_fft=1024, hop=160,
win=800 periodic hann, center=True reflect) -> power spectrum -> 32-bin
Slaney mel (librosa-style filterbank, fmin=0, fmax=8000, slaney norm) ->
10*log10(clamp(., 1e-16)).

The STFT is the Kaldi frontend's machinery (``ops/kaldi_mfcc.py``): the
framing gather with its fold VJP, here with true reflection at the edges,
and the power spectrum as two real-DFT matmuls with the window folded into
the DFT matrices at float64 precompute time, under the hand VJP of
``_Power``.  ``fast_dft=True`` (attack-gradient graphs,
``FastPath.dft_bf16``) runs those two matmuls with bf16 operands on the
card; the mel matmul stays float32, as JAX's runs at HIGHEST.

The numpy constants (the config, the Slaney filterbank, the window) are
copies of the JAX module's, which this package does not import.
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from speakerguard_tpu_torch.models.gmm import fast_dot_dtype
from speakerguard_tpu_torch.ops.kaldi_mfcc import _Framer, _Power, dft_matrices

EPSILON = 1e-16


@dataclass(frozen=True)
class LogMelConfig:
    sr: int = 16000
    n_mels: int = 32
    n_fft: int = 1024
    hop_length: int = 160
    win_length: int = 800
    preemphasis: float = 0.97
    fmin: float = 0.0
    fmax: float = 8000.0


AUDIONET_LOGMEL = LogMelConfig()


# --- Slaney mel scale (librosa htk=False) ---------------------------------

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(log_region,
                   _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ)
                   / _LOGSTEP,
                   mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    f)


def slaney_mel_banks(cfg: LogMelConfig) -> np.ndarray:
    """librosa.filters.mel-compatible matrix, shape (n_mels, 1 + n_fft//2)."""
    n_bins = 1 + cfg.n_fft // 2
    fftfreqs = np.linspace(0.0, cfg.sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(cfg.fmin), _hz_to_mel(cfg.fmax),
                          cfg.n_mels + 2)
    mel_f = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:cfg.n_mels + 2] - mel_f[:cfg.n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _stft_window(cfg: LogMelConfig) -> np.ndarray:
    """Periodic hann of win_length, zero-padded centered to n_fft
    (torch.stft semantics)."""
    n = cfg.win_length
    w = 0.5 - 0.5 * np.cos(2.0 * math.pi * np.arange(n) / n)  # periodic hann
    pad_l = (cfg.n_fft - n) // 2
    pad_r = cfg.n_fft - n - pad_l
    return np.pad(w, (pad_l, pad_r)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _consts(cfg: LogMelConfig, device: torch.device) -> dict:
    """The window-folded (n_fft, n_fft//2+1) DFT matrices and the
    (n_fft//2+1, n_mels) filterbank, float32 on the device, built once per
    (config, device)."""
    def dev(a):
        return torch.as_tensor(a, device=device).T.contiguous()
    return {"dft": tuple(dev(m) for m in dft_matrices(_stft_window(cfg),
                                                       cfg.n_fft)),
            "mel_t": dev(slaney_mel_banks(cfg))}


def audionet_logmel(wav: torch.Tensor, cfg: LogMelConfig = AUDIONET_LOGMEL,
                    fast_dft: bool = False) -> torch.Tensor:
    """wav: (B, L) float32 in the *scale* domain ([-1, 1]).  Returns (B, T,
    n_mels) log-mel features, T = 1 + (L-1)//hop (the reference returns
    (B, F, T); the port keeps the framework-wide (B, T, F) layout).
    ``fast_dft``: the DFT matmuls in the fast dtype (attack-gradient graphs
    only).  A float64 wave is computed in float64 throughout (the float32
    constants widened).  A wave shorter than n_fft//2 + 2 samples cannot
    be reflected and raises a ValueError."""
    if wav.ndim != 2:
        raise ValueError("expect (B, L)")
    consts = _consts(cfg, wav.device)
    x = wav[:, 1:] - cfg.preemphasis * wav[:, :-1]    # (B, L-1)
    length = x.shape[1]
    geometry = (length, 1 + length // cfg.hop_length, cfg.n_fft,
                cfg.hop_length, cfg.n_fft // 2)
    frames = _Framer.apply(x, geometry, "reflect")     # (B, T, n_fft)
    power = _Power.apply(frames, *consts["dft"],
                         fast_dot_dtype(wav.device) if fast_dft
                         else torch.promote_types(wav.dtype, torch.float32))
    mel = power @ consts["mel_t"].to(power.dtype)      # (B, T, n_mels)
    return 10.0 * torch.log10(torch.clamp(mel, min=EPSILON))
