"""WAV I/O without torchaudio: scipy-based, normalised float32.

Port of speakerguard_tpu/utils/audio_io.py (numpy and scipy only; a copy,
since this package imports nothing of the JAX package)."""

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> np.ndarray:
    """Returns mono float32 in [-1, 1), shape (L,)."""
    _, data = wavfile.read(path)
    if data.ndim == 2:
        data = data[:, 0]
    if data.dtype == np.int16:
        return (data.astype(np.float32)) / 32768.0
    if data.dtype == np.int32:
        return (data.astype(np.float32)) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def write_wav(path: str, audio: np.ndarray, fs: int = 16000,
              bits: int = 16):
    """audio: float in either the scale or origin domain; saved int16
    (reference attackMain.py:154-166 save_audio semantics)."""
    audio = np.asarray(audio).squeeze()
    if 0.9 * audio.max() <= 1.0 and 0.9 * audio.min() >= -1.0:
        audio = audio * (2.0 ** (bits - 1))
    audio = np.clip(audio, -32768, 32767).astype(np.int16)
    wavfile.write(path, fs, audio)
