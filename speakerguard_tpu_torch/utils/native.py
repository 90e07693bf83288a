"""ctypes binding for the repo's native C++ batch WAV loader
(native/wavloader.cpp).

Port of speakerguard_tpu/utils/native.py.  The library is built with g++ on
first use into the package's build directory (``csrc/_build/``, not under
version control), never into ``native/build/``, whose library belongs to
the JAX package.  A build goes to a temporary name and is renamed into
place, so concurrent processes never load a half-written file.  When the
build or the load fails, ``get_lib()`` returns None and ``build_error()``
says why; callers then fall back to the scipy path and record that they
did (``data/dataset.py``).
"""

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False
_error = None

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "wavloader.cpp")
_SO = os.path.join(_ROOT, "speakerguard_tpu_torch", "csrc", "_build",
                   "libwavloader.so")


def _build():
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-pthread", _SRC, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded ctypes library, or None when it cannot be built or
    loaded (``build_error()`` then says why)."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError) as exc:
            _error = f"{type(exc).__name__}: {exc}" + (
                f"\n{exc.stderr}" if getattr(exc, "stderr", None) else "")
            return None
        lib.load_wav_batch.restype = ctypes.c_int
        lib.load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_float, ctypes.c_int]
        lib.wav_num_samples.restype = ctypes.c_long
        lib.wav_num_samples.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def build_error():
    """Why the library is unavailable (None while it loads or is untried)."""
    return _error


def library_path() -> str:
    return _SO


def load_wav_batch(paths, wav_length, starts, scale=1.0, n_threads=8):
    """paths: list[str]; returns (n, wav_length) float32, each wave read
    from its start (zero-padded when short) and times ``scale``, or None if
    the native loader is unavailable or failed."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, wav_length), dtype=np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = (ctypes.c_long * n)(*[int(s) for s in starts])
    rc = lib.load_wav_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        wav_length, c_starts, ctypes.c_float(scale), n_threads)
    return out if rc == 0 else None


def wav_num_samples(path):
    lib = get_lib()
    if lib is None:
        return None
    n = lib.wav_num_samples(path.encode())
    return None if n < 0 else int(n)
