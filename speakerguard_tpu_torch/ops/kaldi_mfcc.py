"""Kaldi-compatible MFCC frontend, batched over (B, L) waveforms.

Port of speakerguard_tpu/ops/kaldi_mfcc.py (reference model/iv_plda.py:
197-245, model/xv_plda.py:107-156):

    frames (gather) -> dither -> dc-removal -> raw energy -> preemphasis
    -> povey window -> zero-pad to 512 -> power spectrum -> mel fbank
    -> log -> DCT-II ortho -> cepstral lifter -> energy substitution

The power spectrum is a real DFT written as two matmuls with the
(linear) preemphasis and window folded into the DFT matrices at float64
precompute time, exactly as the JAX package does, so both packages round
the same way; its VJP is the JAX package's hand-written one.  So is the
framing gather's (``_Framer``): a fold of reshape-adds instead of autograd's
sort-based scatter of the overlapping frames.

``fast_dft=True`` (attack-gradient graphs, ``FastPath.dft_bf16``) runs the
two DFT matmuls with bf16 operands and float32 accumulation on the card,
the JAX package's Precision.DEFAULT on the accelerator; on the CPU they
stay float32, as JAX's DEFAULT is there.  The exact path is float32.  On
a CUDA tensor the fast path's whole chain runs as the fused kernels of
``ops/mfcc_fast.py``, which raise for a configuration they do not cover;
``mfcc_chain`` is the chain as plain torch.

Parameter set pinned to the reference configuration:
  sample_frequency=16000, frame_shift=10ms, frame_length=25ms,
  round_to_power_of_two -> padded window 512, snip_edges=False,
  preemphasis 0.97, remove_dc_offset, povey window,
  num_mel_bins=30, low_freq=20, high_freq=7600, vtln off,
  use_energy=True (raw), energy_floor=0, cepstral_lifter=22,
  htk_compat=False;  num_ceps=24 (iv_plda) or 30 (xv_plda).

Dithering (dither=1.0 on int16-domain samples) is applied only when a
``torch.Generator`` is passed as ``rng``; it must live on the waveform's
device.
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from speakerguard_tpu_torch.ops.matmul import dot_f32, fast_dot_dtype

EPSILON = 1.1920928955078125e-07  # float32 eps, matches Kaldi's epsilon


@dataclass(frozen=True)
class MfccConfig:
    sample_frequency: int = 16000
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    snip_edges: bool = False
    num_mel_bins: int = 30
    low_freq: float = 20.0
    high_freq: float = 7600.0
    num_ceps: int = 24
    use_energy: bool = True
    energy_floor: float = 0.0
    cepstral_lifter: float = 22.0
    htk_compat: bool = False

    @property
    def window_size(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms / 1000.0)

    @property
    def window_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        # round_to_power_of_two=True
        return 1 << (self.window_size - 1).bit_length()


IV_PLDA_MFCC = MfccConfig(num_ceps=24)
XV_PLDA_MFCC = MfccConfig(num_ceps=30)


def num_frames(num_samples: int, cfg: MfccConfig) -> int:
    if cfg.snip_edges:
        if num_samples < cfg.window_size:
            return 0
        return 1 + (num_samples - cfg.window_size) // cfg.window_shift
    return (num_samples + cfg.window_shift // 2) // cfg.window_shift


# ---------------------------------------------------------------------------
# constants: window function, mel filterbank, DCT, lifter (numpy, float64)
# ---------------------------------------------------------------------------

def feature_window(cfg: MfccConfig) -> np.ndarray:
    """Kaldi's povey window, the one window of both model configurations."""
    n = cfg.window_size
    i = np.arange(n, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2.0 * math.pi / (n - 1) * i)) ** 0.85
    return w.astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(cfg: MfccConfig) -> np.ndarray:
    """Kaldi triangular mel filterbank, shape (num_mel_bins, n_fft//2 + 1).

    The nyquist column is zero (Kaldi only uses bins 0..n_fft//2-1).
    """
    n_fft = cfg.padded_window_size
    num_fft_bins = n_fft // 2
    nyquist = 0.5 * cfg.sample_frequency
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    assert 0 <= cfg.low_freq < high_freq <= nyquist

    fft_bin_width = cfg.sample_frequency / n_fft
    mel_low = mel_scale(cfg.low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bin_idx = np.arange(cfg.num_mel_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)[None, :]
    mel = mel_scale(freqs)
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up_slope, down_slope))
    banks = np.concatenate(
        [banks, np.zeros((cfg.num_mel_bins, 1))], axis=1)  # zero nyquist col
    return banks.astype(np.float32)


def dct_matrix(cfg: MfccConfig) -> np.ndarray:
    """Orthonormal DCT-II matrix, shape (num_ceps, num_mel_bins)."""
    n = cfg.num_mel_bins
    k = np.arange(cfg.num_ceps, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(math.pi / n * (j + 0.5) * k)
    m[0, :] = math.sqrt(1.0 / n)
    return m.astype(np.float32)


def lifter_coeffs(cfg: MfccConfig) -> np.ndarray:
    q = cfg.cepstral_lifter
    i = np.arange(cfg.num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _geometry_index(geometry: tuple, edge: str,
                    device: torch.device) -> torch.Tensor:
    """(T, win) sample indices of the frames of ``geometry`` = (length, t,
    win, shift, pad), cached on the device (a host-to-device copy per call
    would stall the host on every frontend pass).  Frame t starts at
    sample t*shift - pad; out-of-range samples are mirrored, with the edge
    sample duplicated for edge "kaldi" (-1 -> 0, L -> L-1) or left out for
    "reflect" (-1 -> 1, L -> L-2, torch.stft's center=True; pad < L, so
    that no sample is reflected twice)."""
    length, t, win, shift, pad = geometry
    idx = np.arange(t)[:, None] * shift - pad + np.arange(win)[None, :]
    if edge == "kaldi":
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= length, 2 * length - 1 - idx, idx)
    elif edge == "reflect":
        if idx.min() <= -length:  # a second reflection, which the fold
            raise ValueError("wav too short to frame")  # does not undo
        idx = np.abs(idx)
        idx = np.where(idx >= length, 2 * (length - 1) - idx, idx)
    else:
        raise ValueError(f"unknown edge {edge!r}")
    if not ((idx >= 0).all() and (idx < length).all()):
        raise ValueError("wav too short to frame")
    return torch.as_tensor(idx, device=device)


def _mfcc_geometry(length: int, cfg: MfccConfig) -> tuple:
    """(length, t, win, shift, pad) of the MFCC frames; snip_edges=False
    centres frame t on sample t*shift + shift//2."""
    win, shift = cfg.window_size, cfg.window_shift
    pad = 0 if cfg.snip_edges else win // 2 - shift // 2
    return (length, num_frames(length, cfg), win, shift, pad)


def _frame_index(length: int, cfg: MfccConfig,
                 device: torch.device) -> torch.Tensor:
    """(T, win) sample indices of the MFCC frames (edge "kaldi")."""
    return _geometry_index(_mfcc_geometry(length, cfg), "kaldi", device)


class _Framer(torch.autograd.Function):
    """The framing gather with the JAX package's scatter-free VJP
    (kaldi_mfcc.py _framer).  The cotangent is folded in "extended"
    coordinates e = sample + pad, where frame t's taps [k*shift,
    (k+1)*shift) land on the contiguous range [(t + k)*shift, (t + k +
    1)*shift): ceil(win/shift) reshape-adds, then the two reflected edges
    are flip-added back.  Edge "kaldi": e in [0, pad) is sample pad-1-e and
    e in [pad+L, ext) is sample L-1-(e-pad-L).  Edge "reflect": e in [0,
    pad) is sample pad-e and e in [pad+L, ext) is sample L-2-(e-pad-L)."""

    @staticmethod
    def forward(ctx, wav, geometry, edge):
        ctx.geometry, ctx.edge = geometry, edge
        return wav[:, _geometry_index(geometry, edge, wav.device)]

    @staticmethod
    def backward(ctx, cot):
        length, t, win, shift, pad = ctx.geometry
        b = cot.shape[0]
        ext = (t - 1) * shift + win
        g_ext = cot.new_zeros((b, ext + shift))  # slack for the last chunk
        for k in range(-(-win // shift)):
            w = min(shift, win - k * shift)
            seg = cot[:, :, k * shift:k * shift + w]
            if w < shift:
                seg = torch.nn.functional.pad(seg, (0, shift - w))
            g_ext[:, k * shift:k * shift + t * shift] += seg.reshape(
                b, t * shift)
        g = g_ext[:, pad:pad + length].clone()
        right = ext - pad - length
        lo = 0 if ctx.edge == "kaldi" else 1   # the first mirrored sample
        if pad > 0:
            g[:, lo:lo + pad] += g_ext[:, :pad].flip(-1)
        if right > 0:
            g[:, length - lo - right:length - lo] += (
                g_ext[:, pad + length:ext].flip(-1))
        return g, None, None


def frame_signal(wav: torch.Tensor, cfg: MfccConfig) -> torch.Tensor:
    """(B, L) -> (B, T, window_size) frames.

    snip_edges=False: frame t covers original samples
    [t*shift + shift//2 - win//2, ...), matching Kaldi/torchaudio, with the
    fold backward of ``_Framer``; snip_edges=True is a plain gather.
    """
    if cfg.snip_edges:
        return wav[:, _frame_index(wav.shape[1], cfg, wav.device)]
    return _Framer.apply(wav, _mfcc_geometry(wav.shape[1], cfg), "kaldi")


def dft_matrices(window: np.ndarray, n_fft: int,
                 preemph: float | None = None):
    """(cos, sin) real-DFT matrices of shape (n_fft//2+1, len(window)),
    float32, with the window and (when given) the preemphasis folded in:
    M = DFT · diag(window) · P, computed in float64, where P[j,j]=1,
    P[j,j-1]=-preemph and P[0,0]=1-preemph (Kaldi's duplicated first
    sample)."""
    win = len(window)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    j = np.arange(win, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * k * j / n_fft
    m = np.diag(np.asarray(window, np.float64))
    if preemph is not None:
        p = np.eye(win)
        p[np.arange(1, win), np.arange(win - 1)] = -preemph
        p[0, 0] = 1.0 - preemph
        m = m @ p
    return ((np.cos(ang) @ m).astype(np.float32),
            (np.sin(ang) @ m).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _consts(cfg: MfccConfig, device: torch.device) -> dict:
    """Every constant matrix of the frontend, float32 on the device, built
    once per (config, device)."""
    def dev(a):
        return torch.as_tensor(a, device=device)
    dft = dft_matrices(feature_window(cfg), cfg.padded_window_size,
                       cfg.preemphasis_coefficient)
    return {"dft": tuple(dev(m).T.contiguous() for m in dft),
            "mel_t": dev(mel_banks(cfg)).T.contiguous(),
            "dct_t": dev(dct_matrix(cfg)).T.contiguous(),
            "lifter": dev(lifter_coeffs(cfg))}


class _Power(torch.autograd.Function):
    """|DFT|^2 of the frames with the two DFT matmuls' operands in
    ``dtype`` (f32 accumulation) both ways, under the JAX package's hand
    VJP (kaldi_mfcc.py _rfft_power): d|X_k|^2/df_j = 2 (re_k cos_kj -
    im_k sin_kj)."""

    @staticmethod
    def forward(ctx, frames, cos_t, sin_t, dtype):
        f = frames.to(dtype)
        re = dot_f32(f, cos_t.to(dtype))
        im = -dot_f32(f, sin_t.to(dtype))
        ctx.save_for_backward(re, im, cos_t, sin_t)
        ctx.dtype = dtype
        return re ** 2 + im ** 2

    @staticmethod
    def backward(ctx, cot):
        re, im, cos_t, sin_t = ctx.saved_tensors
        dt = ctx.dtype
        a = dot_f32((cot * re).to(dt), cos_t.T.to(dt))
        b = dot_f32((cot * im).to(dt), sin_t.T.to(dt))
        return 2.0 * (a - b), None, None, None


def dither_noise(rng, shape, device) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` for the dither: drawn from
    ``rng`` when it is a torch.Generator, else ``rng(shape)``, a caller's
    draw function (the CPU tests pass the JAX package's draws in)."""
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device=device,
                           dtype=torch.float32)
    noise = torch.as_tensor(rng(tuple(shape)), dtype=torch.float32,
                            device=device)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"dither draw of shape {tuple(noise.shape)}, "
                         f"expected {tuple(shape)}")
    return noise


def kaldi_mfcc(wav: torch.Tensor, cfg: MfccConfig = IV_PLDA_MFCC,
               rng=None, fast_dft: bool = False) -> torch.Tensor:
    """Batched Kaldi MFCC.  wav: (B, L) float32 in the *origin* (int16)
    domain.  Returns (B, T, num_ceps).  ``rng``: None (no dither), a
    torch.Generator or a draw function ``draw(shape)`` (``dither_noise``).
    ``fast_dft``: the DFT matmuls in the fast dtype (attack-gradient graphs
    only); on a CUDA tensor the chain's fused kernels."""
    if wav.ndim != 2:
        raise ValueError("expect (B, L)")
    noise = None
    if rng is not None and cfg.dither != 0.0:
        shape = (wav.shape[0], num_frames(wav.shape[1], cfg), cfg.window_size)
        noise = dither_noise(rng, shape, wav.device)
    if fast_dft and wav.device.type == "cuda":
        from speakerguard_tpu_torch.ops.mfcc_fast import mfcc
        return mfcc(wav, cfg, noise)
    return mfcc_chain(wav, cfg, noise, fast_dft)


def mfcc_chain(wav: torch.Tensor, cfg: MfccConfig, noise=None,
               fast_dft: bool = False) -> torch.Tensor:
    """``kaldi_mfcc``'s chain in plain torch, the dither's standard normal
    (B, T, window) draw given as ``noise`` (None: no dither)."""
    dev = wav.device
    consts = _consts(cfg, dev)
    frames = frame_signal(wav.to(torch.float32), cfg)  # (B, T, W)

    if noise is not None:
        frames = frames + cfg.dither * noise

    if cfg.remove_dc_offset:
        frames = frames - torch.mean(frames, dim=-1, keepdim=True)

    if cfg.use_energy:
        # raw energy: taken before preemphasis and window
        log_energy = torch.log(torch.clamp(
            torch.sum(frames * frames, dim=-1), min=EPSILON))

    # preemphasis + window are linear: folded into the DFT matrices
    power = _Power.apply(frames, *consts["dft"],
                         fast_dot_dtype(dev) if fast_dft else torch.float32)

    mel = power @ consts["mel_t"]
    mel = torch.log(torch.clamp(mel, min=EPSILON))

    feat = mel @ consts["dct_t"]
    if cfg.cepstral_lifter != 0.0:
        feat = feat * consts["lifter"]

    if cfg.use_energy:
        if cfg.energy_floor > 0.0:
            log_energy = torch.clamp(log_energy,
                                     min=math.log(cfg.energy_floor))
        feat = torch.cat([log_energy[..., None], feat[..., 1:]], dim=-1)
    return feat
