"""Imperceptibility metrics: L0/L1/L2/Linf, SNR, PESQ, STOI.

Port of speakerguard_tpu/metrics/metric.py (reference metric/metric.py): a
copy, since this package imports nothing of the JAX package.  Lp/SNR are
plain numpy; STOI is the native implementation below (Taal et al. 2011
short-time objective intelligibility); PESQ (ITU-T P.862) uses the compiled
`pesq` package when it is installed, else this package's
metrics/pesq_native.py.

Everything here stays numpy on the host, as in the JAX package: the metrics
run after generation (cli/test_attack.py), off the attack's hot path, and
one 3 s utterance takes ~70 ms of one CPU core after the first call,
nothing beside an attack.
"""

import math
import warnings

import numpy as np
from scipy import signal as ssig

LOWER, UPPER = -1, 1


def preprocess(x, bits=16):
    x = np.asarray(x, np.float64).flatten()
    if not (LOWER <= x.max() <= UPPER):
        x = x / (2 ** (bits - 1))
    return x


def Lp(benign, adver, p, bits=16):
    return float(np.linalg.norm(preprocess(adver, bits)
                                - preprocess(benign, bits), p))


def L2(benign, adver, bits=16):
    return Lp(benign, adver, 2, bits)


def L0(benign, adver, bits=16):
    return Lp(benign, adver, 0, bits)


def L1(benign, adver, bits=16):
    return Lp(benign, adver, 1, bits)


def Linf(benign, adver, bits=16):
    return Lp(benign, adver, np.inf, bits)


def SNR(benign, adver, bits=16):
    b = preprocess(benign, bits)
    a = preprocess(adver, bits)
    power_noise = np.sum((a - b) ** 2)
    if power_noise <= 0:
        return np.inf
    return float(10 * np.log10(np.sum(b ** 2) / power_noise))


# ---------------------------------------------------------------------------
# STOI (native implementation)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_N_FRAME = 256
_NFFT = 512
_NUMBAND = 15
_MINFREQ = 150
_N = 30          # 384 ms segments
_BETA = -15.0
_DYN_RANGE = 40.0


def _thirdoct():
    f = np.linspace(0, _STOI_FS, _NFFT + 1)[: _NFFT // 2 + 1]
    k = np.arange(_NUMBAND)
    cf = _MINFREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((_NUMBAND, len(f)))
    for i in range(_NUMBAND):
        fl_idx = np.argmin((f - lo[i]) ** 2)
        fh_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, fl_idx:fh_idx] = 1.0
    return obm


def _stft_frames(x):
    w = np.hanning(_N_FRAME + 2)[1:-1]
    n_frames = (len(x) - _N_FRAME) // (_N_FRAME // 2) + 1
    if n_frames <= 0:
        return np.zeros((0, _NFFT // 2 + 1))
    idx = (np.arange(n_frames) * (_N_FRAME // 2))[:, None] + \
        np.arange(_N_FRAME)[None, :]
    frames = x[idx] * w
    return np.fft.rfft(frames, n=_NFFT, axis=-1)


def _remove_silent_frames(x, y):
    w = np.hanning(_N_FRAME + 2)[1:-1]
    hop = _N_FRAME // 2
    n_frames = (len(x) - _N_FRAME) // hop + 1
    idx = (np.arange(n_frames) * hop)[:, None] + np.arange(_N_FRAME)[None, :]
    xf = x[idx] * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-14)
    mask = energies > (np.max(energies) - _DYN_RANGE)
    xs = np.zeros_like(x)
    ys = np.zeros_like(y)
    count = 0
    for i in np.where(mask)[0]:
        s = count * hop
        xs[s:s + _N_FRAME] += x[idx[i]] * w
        ys[s:s + _N_FRAME] += y[idx[i]] * w
        count += 1
    n = count * hop + _N_FRAME - hop
    return xs[:n], ys[:n]


def STOI(benign, adver, fs=16000, bits=16, extended=False):
    """Short-time objective intelligibility (Taal et al., 2011)."""
    x = preprocess(benign, bits)
    y = preprocess(adver, bits)
    if fs != _STOI_FS:
        g = math.gcd(_STOI_FS, fs)
        x = ssig.resample_poly(x, _STOI_FS // g, fs // g)
        y = ssig.resample_poly(y, _STOI_FS // g, fs // g)
    x, y = _remove_silent_frames(x, y)
    obm = _thirdoct()
    xs = np.sqrt(np.maximum(obm @ (np.abs(_stft_frames(x).T) ** 2), 1e-30))
    ys = np.sqrt(np.maximum(obm @ (np.abs(_stft_frames(y).T) ** 2), 1e-30))
    if xs.shape[1] < _N:
        warnings.warn("signal too short for STOI; returning 1e-5")
        return 1e-5
    c = 10 ** (-_BETA / 20.0)
    d_sum = 0.0
    m_count = 0
    for m in range(_N, xs.shape[1] + 1):
        xseg = xs[:, m - _N:m]
        yseg = ys[:, m - _N:m]
        alpha = np.sqrt(np.sum(xseg ** 2, axis=1, keepdims=True)
                        / (np.sum(yseg ** 2, axis=1, keepdims=True) + 1e-30))
        yprime = np.minimum(alpha * yseg, xseg * (1 + c))
        xn = xseg - xseg.mean(axis=1, keepdims=True)
        yn = yprime - yprime.mean(axis=1, keepdims=True)
        xn /= (np.linalg.norm(xn, axis=1, keepdims=True) + 1e-30)
        yn /= (np.linalg.norm(yn, axis=1, keepdims=True) + 1e-30)
        d_sum += np.sum(xn * yn)
        m_count += 1
    return float(d_sum / (m_count * _NUMBAND))


def PESQ(benign, adver, bits=16):
    """ITU-T P.862 wideband PESQ.  Uses the compiled `pesq` package when
    installed, else the native numpy implementation (metrics/pesq_native.py;
    see its docstring for conformance caveats)."""
    b = preprocess(benign, bits)
    a = preprocess(adver, bits)
    try:
        from pesq import pesq as _pesq
        return _pesq(16000, b, a, "wb" if bits == 16 else "nb")
    except ImportError:
        from speakerguard_tpu_torch.metrics.pesq_native import pesq_wb
        return pesq_wb(b, a)


def get_all_metric(benign, adver, fs=16000, bits=16):
    """[L2, L0, L1, Linf, SNR, PESQ, STOI] (reference metric.py:56-63)."""
    return [L2(benign, adver, bits), L0(benign, adver, bits),
            L1(benign, adver, bits), Linf(benign, adver, bits),
            SNR(benign, adver, bits), PESQ(benign, adver, bits),
            STOI(benign, adver, fs, bits)]
