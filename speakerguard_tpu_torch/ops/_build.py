"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  Libraries go to ``csrc/_build/``
(listed in .gitignore), named by a hash of their source and of every
shared header ``csrc/*.cuh``, so an edited kernel or header is rebuilt.
Nothing here runs at import time.
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


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


def launch_on(device, fn, *args) -> int:
    """``fn(*args, stream)``: a C entry point called with ``device``'s
    card current (a launch goes to the current card) and the raw handle of
    that card's current stream last.  The guard is entered only when
    another card is current: an attack step makes dozens of launches, and
    the guard and a ``torch.cuda.Stream`` object cost more host time than
    the entry point itself."""
    idx = torch.cuda.current_device() if device.index is None else \
        device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def check_rc(rc: int, what: str):
    """Raise unless a C entry point's cudaGetLastError() code is 0."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


class KernelWrapper:
    """Base of the kernel wrappers: ``launches`` counts kernel launches
    (CUDA tensors), ``plain_calls`` the plain-version runs (CPU tensors)."""

    name = "kernel"

    def __init__(self):
        self.reset_counts()

    def reset_counts(self):
        self.launches = 0
        self.plain_calls = 0

    def route(self, t) -> bool:
        """True when ``t`` is a CUDA tensor (launch), False on the CPU
        (plain version, counted here); raises on any other device."""
        if t.device.type == "cpu":
            self.plain_calls += 1
            return False
        if t.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda or cpu, not "
                             f"{t.device}")
        return True
