"""Speech-compression defenses: the seven ffmpeg codecs, MULAW and ADPCM.

Port of speakerguard_tpu/defenses/speech_compression.py (reference
defense/speech_compression.py).  Every codec is a function ``f(audio,
param, fs=16000, n_jobs=..., draw=None)`` over (B, L) (or (L,), (B, 1, L))
and goes through ``adaptive/bpda.py`` with an identity backward
(straight-through), as the reference wraps its non-differentiable codecs.
The codecs draw nothing; ``draw`` is taken as every defense takes it.

The ffmpeg codecs (OPUS, SPEEX, AMR, AAC_V, AAC_C, MP3_V, MP3_C) copy the
batch to the host and round-trip each wave through two ffmpeg subprocesses
in a thread pool, with the JAX package's command lines, its batch-wide
domain sniff, int16 clip and cast, per-codec start hints, min-L1
realignment and zero-pad of short outputs; then copy back.  Without an
ffmpeg on PATH they raise at call time, as the reference does.

MULAW (G.711 companding) is elementwise torch.  ADPCM (IMA, DVI4) is a
serial recurrence over time: ``ops/adpcm.py`` runs it, with the defense's
domain scaling fused in, as the CUDA kernel ``csrc/adpcm.cu`` on a CUDA
tensor, as its plain torch loop on a CPU one.
"""

import functools
import os
import shlex
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from speakerguard_tpu_torch.adaptive.bpda import bpda
from speakerguard_tpu_torch.defenses.time_domain import _flatten_wav
from speakerguard_tpu_torch.ops.adpcm import adpcm
from speakerguard_tpu_torch.utils.ranges import ABS_MAX


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _write_wav(path, fs, audio_int16):
    from scipy.io.wavfile import write
    write(path, fs, audio_int16)


def _read_wav(path):
    from scipy.io.wavfile import read
    _, data = read(path)
    return data


def _roundtrip_one(audio: np.ndarray, name: str, param, fs: int,
                   start_hint, tmp_dir: str, idx: int) -> np.ndarray:
    """audio: int16 (L,) -> decoded int16 (L,): cut at the start hint or
    at the offset of least L1 distance, or zero-padded when short."""
    src = os.path.join(tmp_dir, f"{idx}.wav")
    _write_wav(src, fs, audio)
    coded = os.path.join(tmp_dir, f"{idx}.{name}")
    cmd1 = (f"ffmpeg -y -i {src} -ac 1 -ar {fs} {param[0]} {param[1]} "
            f"-c:a {param[2]} {coded}")
    dec = os.path.join(tmp_dir, f"{idx}-dec.wav")
    cmd2 = f"ffmpeg -y -i {coded} -ac 1 -ar {fs} -c:a pcm_s16le {dec}"
    for cmd in (cmd1, cmd2):
        subprocess.run(shlex.split(cmd), check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    out = _read_wav(dec)
    n = len(audio)
    if out.size <= n:
        return np.pad(out, (0, n - out.size)).astype(np.int16)
    start = start_hint
    if start is None:
        a = audio.astype(np.float64) / ABS_MAX
        o = out.astype(np.float64) / ABS_MAX
        dists = [np.abs(a - o[s:s + n]).sum()
                 for s in range(0, out.size - n + 1)]
        start = int(np.argmin(dists))
    return out[start:start + n].astype(np.int16)


def _compression_host(new: np.ndarray, name: str, param, fs: int,
                      start_hint, n_jobs: int = 10) -> np.ndarray:
    """new: float (B, L) in either domain -> float32, same shape and
    domain.  One scale decision for the whole batch."""
    if not ffmpeg_available():
        raise RuntimeError(
            "speech-compression defenses require ffmpeg with codec support "
            "(libopus/libspeex/amr/fdk-aac/mp3); see the reference's "
            "instructions_ffmpeg.md")
    x = np.asarray(new)
    scale = bool(x.min() >= -2.0 and x.max() <= 2.0)
    if scale:
        x = x * ABS_MAX
    x = np.clip(x, -ABS_MAX, ABS_MAX - 1).astype(np.int16)
    b = x.shape[0]
    out = np.empty_like(x)
    tmp_dir = tempfile.mkdtemp(prefix=f"{name}-coding-")
    try:
        def work(i):
            out[i] = _roundtrip_one(x[i], name, param, fs, start_hint,
                                    tmp_dir, i)
        if b == 1 or n_jobs <= 1:
            for i in range(b):
                work(i)
        else:
            with ThreadPoolExecutor(max_workers=min(n_jobs, b)) as ex:
                list(ex.map(work, range(b)))
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    res = out.astype(np.float32)
    if scale:
        res = res / ABS_MAX
    return res


def _make_codec(name: str, args3, start_hint):
    """An ffmpeg codec: (B, L) on any device -> the host round-trip, back
    on the input's device, straight-through in the backward."""

    @functools.lru_cache(maxsize=None)
    def ste_for(param, fs, n_jobs):
        def non_diff(audio):
            x, restore = _flatten_wav(audio)
            y = _compression_host(x.detach().cpu().numpy(), name,
                                  [args3[0], str(param), args3[1]], fs,
                                  start_hint, n_jobs)
            return restore(torch.from_numpy(y).to(audio.device))
        return bpda(non_diff)

    def codec(audio, param, fs=16000, n_jobs=10, draw=None):
        return ste_for(param, fs, n_jobs)(audio)

    return codec


OPUS = _make_codec("opus", ("-b:a", "libopus"), 69)
SPEEX = _make_codec("spx", ("-b:a", "libspeex"), None)
AAC_V = _make_codec("aac", ("-vbr", "libfdk_aac"), 2048)
AAC_C = _make_codec("aac", ("-b:a", "libfdk_aac"), 2048)
MP3_V = _make_codec("mp3", ("-q:a", "mp3"), 0)
MP3_C = _make_codec("mp3", ("-b:a", "mp3"), 0)

_AMR_WB = _make_codec("amr", ("-b:a", "libvo_amrwbenc"), None)
_AMR_NB = _make_codec("amr", ("-b:a", "libopencore_amrnb"), None)

_AMR_LEGAL = {16000: [6600, 8850, 12650, 14250, 15850, 18250, 19850, 23050,
                      23850],
              8000: [4750, 5150, 5900, 6700, 7400, 7950, 10200, 12200]}


def AMR(audio, param=6600, fs=16000, n_jobs=10, draw=None):
    if fs not in _AMR_LEGAL:
        raise NotImplementedError("AMR supports fs in {16000, 8000}")
    if int(param) not in _AMR_LEGAL[fs]:
        raise NotImplementedError(f"{param} not allowed for fs={fs}")
    codec = _AMR_WB if fs == 16000 else _AMR_NB
    return codec(audio, param, fs, n_jobs=n_jobs)


# defaults per reference speech_compression.py:139-201
DEFAULT_PARAMS = {"OPUS": 16000, "SPEEX": 43200, "AMR": 6600, "AAC_V": 5,
                  "AAC_C": 20000, "MP3_V": 9, "MP3_C": 16000,
                  "MULAW": 255, "ADPCM": 4}


# ---------------------------------------------------------------------------
# the ffmpeg-free codecs, on the device
# ---------------------------------------------------------------------------

def _to_scale(audio):
    """The batch-wide domain sniff of the ffmpeg codecs, branch-free:
    (audio in the scale domain, the factor that restores its domain)."""
    big = torch.logical_or(torch.max(audio) > 2.0, torch.min(audio) < -2.0)
    factor = torch.where(big, audio.new_tensor(1.0 / ABS_MAX),
                         audio.new_tensor(1.0))
    return audio * factor, torch.where(big, audio.new_tensor(ABS_MAX),
                                       audio.new_tensor(1.0))


def _mulaw_nondiff(audio, mu: float):
    x, restore = _to_scale(audio)
    mu_t = audio.new_tensor(mu)
    x = torch.clamp(x, -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu_t * torch.abs(x)) / torch.log1p(mu_t)
    # quantize the companded signal to (mu+1) levels (8-bit for mu=255);
    # torch.round rounds half to even, as jnp.round does
    q = torch.round((y + 1.0) * 0.5 * mu_t) / mu_t * 2.0 - 1.0
    dec = torch.sign(q) * (torch.pow(1.0 + mu_t, torch.abs(q)) - 1.0) / mu_t
    return dec * restore


def _adpcm_nondiff(audio, bits: int):
    """IMA ADPCM encode + decode over the time axis (ops/adpcm.py): the
    batch-wide domain sniff, the int16 scaling and clamp, the round trip
    and the scaling back, one reduction and one kernel launch on the card.
    audio: (B, L), (L,) or (B, 1, L); bits=4 is the standard nibble
    coder."""
    wav, restore_shape = _flatten_wav(audio)
    return restore_shape(adpcm.scaled(wav, bits))


@functools.lru_cache(maxsize=None)
def _mulaw_ste(mu: float):
    return bpda(lambda a: _mulaw_nondiff(a, mu))


@functools.lru_cache(maxsize=None)
def _adpcm_ste(bits: int):
    return bpda(lambda a: _adpcm_nondiff(a, bits))


def MULAW(audio, param=255, fs=16000, n_jobs=None, draw=None):
    """µ-law (G.711) compand -> quantize -> expand, on the device."""
    return _mulaw_ste(float(param))(audio)


def ADPCM(audio, param=4, fs=16000, n_jobs=None, draw=None):
    """IMA ADPCM round-trip (param = bits per sample), on the device."""
    return _adpcm_ste(int(param))(audio)
