"""Operations of the Kaldi front end at a cell's shapes, counted from its
mathematics: a real FFT of each zero-padded frame (2.5 n log2 n), the
mel bank and the DCT as products.  Framing, dither, energies and logs are
elementwise and not counted.  The input gradient costs the same
products again."""

import math


def frames(cfg: dict, samples: int) -> tuple:
    """(frames T, window, n_fft) of one wave."""
    fe = cfg["frontend"]
    sr = fe["sample_rate"]
    win = int(sr * fe["frame_length_ms"] / 1000)
    shift = int(sr * fe["frame_shift_ms"] / 1000)
    return (samples + shift // 2) // shift, win, 1 << (win - 1).bit_length()


def forward(cfg: dict, batch: int, samples: int) -> float:
    fe = cfg["frontend"]
    t, _, n_fft = frames(cfg, samples)
    rows = batch * t
    bins = n_fft // 2 + 1
    fft = 2.5 * n_fft * math.log2(n_fft)
    return rows * (fft + 2.0 * bins * fe["num_mel_bins"]
                   + 2.0 * fe["num_mel_bins"] * fe["num_ceps"])
