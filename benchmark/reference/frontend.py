"""Plain float32 Kaldi front end: MFCC, add-deltas and sliding CMN.

Written from Kaldi's definitions (feat/feature-window.cc, mel-computations,
feature-mfcc.cc, add-deltas, apply-cmvn-sliding) in plain torch: frames cut
with Kaldi's edge mirroring (snip_edges=false), dither, DC removal, raw log
energy, pre-emphasis, the povey window, ``torch.fft.rfft`` of the frame
zero-padded to a power of two, the triangular mel bank, log, orthonormal
DCT-II, the cepstral lifter and C0 replaced by the log energy.  It imports
nothing of the program; every constant is built here from the config.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = float(np.finfo(np.float32).eps)


def geometry(cfg: dict, num_samples: int):
    """(window, shift, n_fft, frames) of a wave of ``num_samples``."""
    sr = cfg["sample_rate"]
    win = int(sr * cfg["frame_length_ms"] / 1000)
    shift = int(sr * cfg["frame_shift_ms"] / 1000)
    n_fft = 1 << (win - 1).bit_length()
    return win, shift, n_fft, (num_samples + shift // 2) // shift


def _frame_index(num_samples, win, shift, t):
    """Kaldi's sample index of each frame tap, snip_edges=false: frame t
    starts at t*shift + shift/2 - win/2; outside the wave it mirrors with
    the edge sample repeated (-1 -> 0, L -> L-1)."""
    idx = (np.arange(t)[:, None] * shift + shift // 2 - win // 2
           + np.arange(win)[None, :])
    while (idx < 0).any() or (idx >= num_samples).any():
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= num_samples, 2 * num_samples - 1 - idx, idx)
    return idx


def _mel_bank(cfg, n_fft):
    """(num_bins, n_fft//2 + 1) triangles on Kaldi's mel scale; the Nyquist
    bin gets no weight, as in Kaldi."""
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)
    n_bins = cfg["num_mel_bins"]
    lo, hi = mel(cfg["low_freq"]), mel(cfg["high_freq"])
    step = (hi - lo) / (n_bins + 1)
    f = cfg["sample_rate"] / n_fft * np.arange(n_fft // 2)
    m = mel(f)
    bank = np.zeros((n_bins, n_fft // 2 + 1))
    for b in range(n_bins):
        left, centre, right = lo + b * step, lo + (b + 1) * step, \
            lo + (b + 2) * step
        up = (m - left) / (centre - left)
        down = (right - m) / (right - centre)
        bank[b, :n_fft // 2] = np.clip(np.minimum(up, down), 0.0, None)
    return bank


def _dct(num_ceps, n):
    k = np.arange(num_ceps)[:, None]
    j = np.arange(n)[None, :]
    m = math.sqrt(2.0 / n) * np.cos(math.pi / n * (j + 0.5) * k)
    m[0] = math.sqrt(1.0 / n)
    return m


class Mfcc:
    """Constants of one configuration on one device."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = device
        sr_win = int(cfg["sample_rate"] * cfg["frame_length_ms"] / 1000)
        i = np.arange(sr_win)
        povey = (0.5 - 0.5 * np.cos(2 * math.pi * i / (sr_win - 1))) ** 0.85
        q = cfg["cepstral_lifter"]
        lifter = 1.0 + 0.5 * q * np.sin(math.pi * np.arange(cfg["num_ceps"])
                                        / q)
        _, _, n_fft, _ = geometry(cfg, sr_win)

        def t(a):
            return torch.tensor(a, dtype=torch.float32, device=device)
        self.window = t(povey)
        self.bank_t = t(_mel_bank(cfg, n_fft).T)
        self.dct_t = t(_dct(cfg["num_ceps"], cfg["num_mel_bins"]).T)
        self.lifter = t(lifter)
        self.n_fft = n_fft

    def __call__(self, wav: torch.Tensor, dither=None) -> torch.Tensor:
        """wav (B, L) float32 in the int16 range -> (B, T, num_ceps).
        ``dither`` (B, T, window) standard normal draws, or None."""
        cfg = self.cfg
        win, shift, n_fft, t = geometry(cfg, wav.shape[1])
        idx = torch.as_tensor(_frame_index(wav.shape[1], win, shift, t),
                              device=wav.device)
        fr = wav[:, idx]                                    # (B, T, win)
        if dither is not None and cfg["dither"] != 0.0:
            fr = fr + cfg["dither"] * dither
        fr = fr - fr.mean(dim=-1, keepdim=True)
        log_energy = torch.log(torch.clamp((fr * fr).sum(-1), min=EPS))
        a = cfg["preemphasis"]
        fr = torch.cat([fr[..., :1] * (1.0 - a),
                        fr[..., 1:] - a * fr[..., :-1]], dim=-1)
        fr = fr * self.window
        spec = torch.fft.rfft(fr, n=n_fft)
        power = spec.real ** 2 + spec.imag ** 2
        mel = torch.log(torch.clamp(power @ self.bank_t, min=EPS))
        ceps = (mel @ self.dct_t) * self.lifter
        return torch.cat([log_energy[..., None], ceps[..., 1:]], dim=-1)


def add_deltas(feat: torch.Tensor, window: int, order: int) -> torch.Tensor:
    """Kaldi add-deltas: each order is the previous one convolved with the
    regression kernel j / sum(j^2), j in [-window, window]; frames beyond
    the ends repeat the edge frame.  (B, T, F) -> (B, T, F (order+1))."""
    kernels = [np.array([1.0])]
    reg = np.arange(-window, window + 1) / float(
        sum(j * j for j in range(-window, window + 1)))
    for _ in range(order):
        kernels.append(np.convolve(kernels[-1], reg))
    outs = []
    for k in kernels:
        half = (len(k) - 1) // 2
        x = F.pad(feat.transpose(1, 2), (half, half), mode="replicate")
        # k[half + j] weighs frame t + j (conv1d correlates); composing two
        # correlations convolves their kernels, hence np.convolve above
        w = torch.tensor(k, dtype=feat.dtype, device=feat.device)
        y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), w.view(1, 1, -1))
        outs.append(y.view(feat.shape[0], feat.shape[2], -1).transpose(1, 2))
    return torch.cat(outs, dim=-1)


def sliding_cmn(feat: torch.Tensor, window: int) -> torch.Tensor:
    """apply-cmvn-sliding --center=true --norm-vars=false: each frame less
    the mean of a ``window``-frame window centred on it, moved inside the
    utterance at its ends (the whole utterance when it is shorter)."""
    t = feat.shape[1]
    avg = np.zeros((t, t))
    for i in range(t):
        start = i - window // 2
        end = start + window
        if start < 0:
            end, start = end - start, 0
        if end > t:
            start, end = max(0, start - (end - t)), t
        avg[i, start:end] = 1.0 / (end - start)
    a = torch.tensor(avg, dtype=feat.dtype, device=feat.device)
    return feat - torch.einsum("ts,bsf->btf", a, feat)
