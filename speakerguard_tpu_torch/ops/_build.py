"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  Libraries go to ``csrc/_build/``
(listed in .gitignore), named by a hash of their source and of every
shared header ``csrc/*.cuh``, so an edited kernel or header is rebuilt.
Nothing here runs at import time.

A kernel's module declares its source's entry points as a ``Library`` and
its wrappers as ``KernelWrapper``s: ``on_card`` sends CUDA tensors to the
kernel and CPU tensors to the plain version, ``Library.launch`` makes the
call.  The module itself holds only its operand checks, its plain version
and the operands of each launch.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# the argument types of the entry points' declarations (a CPU test holds
# each module's table to its source's extern "C" declarations)
PTR, INT, FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns nvcc's
    output (ptxas register and shared-memory usage; empty when nothing was
    compiled); raises if the compile fails."""
    so = library_path(name)
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{log}")
    os.replace(tmp, so)
    return log


def on_card(t, what: str = "the kernel") -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (the plain
    version); raises on any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


class Library:
    """The C entry points of ``csrc/<name>.cu``, built and loaded at the
    first launch.  ``argtypes`` {entry: [argument types]} declares each
    entry point (all return an int); ``consts`` {getter: value} names the
    constants that the source and its Python module both hold, checked
    on load against the C getters'."""

    def __init__(self, name: str, argtypes: dict, consts: dict | None = None):
        self.name, self.argtypes, self.consts = name, argtypes, consts or {}
        self._fns = None

    def entries(self) -> dict:
        """{entry: its declared C function}, loaded once."""
        if self._fns is None:
            build(self.name)
            lib = ctypes.CDLL(str(library_path(self.name)))
            fns = {}
            for entry, args in self.argtypes.items():
                fns[entry] = fn = getattr(lib, entry)
                fn.argtypes, fn.restype = args, ctypes.c_int
            for getter, want in self.consts.items():
                got = fns[getter]()
                if got != want:
                    raise RuntimeError(f"csrc/{self.name}.cu's {getter}() is "
                                       f"{got}, its Python module's {want}")
            self._fns = fns
        return self._fns

    def launch(self, entry: str, device, *args):
        """``entry(*args)`` with tensors passed by pointer, ``device``'s
        card current (a launch goes to the current card) and the raw handle
        of that card's current stream last; raises unless the entry point's
        cudaGetLastError() code is 0."""
        fn = (self._fns or self.entries())[entry]
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        idx = torch.cuda.current_device() if device.index is None else \
            device.index
        # the guard only when another card is current: an attack step makes
        # dozens of launches, and the guard and a torch.cuda.Stream object
        # cost more host time than the entry point itself
        if idx == torch.cuda.current_device():
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
        else:
            with torch.cuda.device(idx):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
        if rc != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                               f"{rc}")


class KernelWrapper:
    """Base of the kernel wrappers: ``route`` sends a call to the kernel of
    ``lib`` or to the plain version (``on_card``) and counts the latter in
    ``plain_calls``; ``_launch`` launches and counts ``launches`` once the
    entry point has returned (a wrapper of several launches makes only its
    last through ``_launch``, so it counts once a call).  The CPU tests
    replace ``on_card`` and ``lib`` to run a wrapper's kernel route with
    each launch emulated."""

    name = "kernel"
    lib: Library
    on_card = staticmethod(on_card)

    def __init__(self):
        self.reset_counts()

    def reset_counts(self):
        self.launches = 0
        self.plain_calls = 0

    def route(self, t) -> bool:
        """True when ``t`` is a CUDA tensor (launch), False on the CPU
        (plain version, counted here); raises on any other device."""
        if self.on_card(t, self.name):
            return True
        self.plain_calls += 1
        return False

    def _launch(self, entry: str, device, *args):
        self.lib.launch(entry, device, *args)
        self.launches += 1
