#!/usr/bin/env python3
"""Time each step of the port's Cholesky sweep kernel on one CUDA card.

    python3 tools/chol_sweep_phases.py [--batch 64] [--n 600]
                                       [--bf16-input] [--bf16-updates]
                                       [--solve]

Builds ``speakerguard_tpu_torch/csrc/chol.cu`` twice into
``speakerguard_tpu_torch/csrc/_build/`` (gitignored): as it is, and a copy
whose ``sweep_kernel`` has a ``clock64()`` timer after each of its
``__syncthreads()`` (thread 0 of each block adds the cycles since the
previous barrier to that barrier's slot) and before the final panel's exit.
Runs ``sg_cholesky_rt`` (``--solve``: ``sg_chol_solve``, whose sweep carries
a right-hand side, then back-substitutes) on an SPD batch at the given
shape with both builds and prints one JSON line: the card, each build's ms
(CUDA events, 20 calls after 3), the result's error against the plain
version, and for each step of the sweep its mean cycles per block, its
share of the cycles, and that share of the instrumented build's ms (with
``--solve`` that ms includes the back-substitution launch).

The steps are the sweep's barriers in source order: ``diag`` (the zero pass
on the first panel, the first stripe column's loads, warp 0's diagonal
factorization), ``stripe``, ``update``, and ``last_stripe`` (the short last
panel, which ends without a barrier).
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from speakerguard_tpu_torch.ops import _build, chol  # noqa: E402

STEPS = ("diag", "stripe", "update")
LAST = 15  # the slot of the last panel's exit
SLOTS = 16

TIMER = r'''
__device__ unsigned long long g_steps[65536 * 16];
#define SG_STEP(k) if (threadIdx.x == 0) { long long t_ = clock64(); \
  g_steps[blockIdx.x * 16 + (k)] += t_ - sg_last; sg_last = t_; }
'''
EXTERN = r'''
extern "C" int sg_steps_read(void* host, int batch) {
  return (int)cudaMemcpyFromSymbol(host, g_steps,
                                   sizeof(unsigned long long) * 16 * batch);
}
extern "C" int sg_steps_reset() {
  void* p;
  cudaError_t err = cudaGetSymbolAddress(&p, g_steps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(p, 0, sizeof(g_steps));
}
'''


def instrument(src: str) -> str:
    """chol.cu with a timer after each barrier of sweep_kernel."""
    head = src.index("sweep_kernel(const T*")
    start = src.rindex("template", 0, head)
    end = src.index("\n}\n", head)
    body = src[start:end]
    count = iter(range(SLOTS))
    body = re.sub(r"__syncthreads\(\);",
                  lambda _: f"__syncthreads(); SG_STEP({next(count)});", body)
    body = body.replace("if (m == 0) break;",
                        f"if (m == 0) {{ SG_STEP({LAST}); break; }}")
    body = body.replace("lane = tid % 32;",
                        "lane = tid % 32;\n  long long sg_last = clock64();", 1)
    return src[:start] + TIMER + body + src[end:] + EXTERN


def build(src: Path, so: Path) -> str:
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return proc.stderr


def spd(b, n, seed):
    """The smoke's 'dominant' input: 0.01 X X^T + (N/10 + 0.5) I."""
    x = torch.tensor(np.random.default_rng(seed).standard_normal(
        (b, n, n)).astype(np.float32) * 0.1, device="cuda")
    return x @ x.mT + (n / 10.0 + 0.5) * torch.eye(n, device="cuda")


def ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--bf16-input", action="store_true")
    ap.add_argument("--bf16-updates", action="store_true")
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args(argv)
    if args.solve and (args.bf16_input or args.bf16_updates):
        ap.error("--solve takes float32 and no bf16 updates")
    if not torch.cuda.is_available():
        print("chol_sweep_phases: no CUDA card visible to torch",
              file=sys.stderr)
        return 1
    b, n = args.batch, args.n
    a = spd(b, n, seed=n)
    if args.bf16_input:
        a = a.to(torch.bfloat16)
    v = torch.tensor(np.random.default_rng(n + 2).standard_normal(
        (b, n)).astype(np.float32), device="cuda")
    want = (chol.chol_solve_plain(a, v) if args.solve
            else chol.cholesky_rt_plain(a, args.bf16_updates))
    out = torch.empty((b, n, n), device="cuda")
    y, x = torch.empty_like(v), torch.empty_like(v)

    src = _build.CSRC / "chol.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    timed_src = _build.BUILD_DIR / "chol_steps.cu"
    timed_src.write_text(instrument(src.read_text()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    rec = {"tool": "chol_sweep_phases", "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "shape": [b, n, n], "dtype": str(a.dtype).split(".")[-1],
           "bf16_updates": args.bf16_updates, "solve": args.solve}
    for tag, path in (("kernel", src), ("instrumented", timed_src)):
        so = _build.BUILD_DIR / f"libchol_steps_{tag}.so"
        build(path, so)
        lib = ctypes.CDLL(str(so))
        name = "sg_chol_solve" if args.solve else "sg_cholesky_rt"
        fn = getattr(lib, name)
        fn.argtypes = chol.ARGTYPES[name]
        fn.restype = i32
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            if args.solve:
                rc = fn(a.data_ptr(), v.data_ptr(), out.data_ptr(),
                        y.data_ptr(), x.data_ptr(), b, n, stream)
            else:
                rc = fn(a.data_ptr(), int(a.dtype == torch.bfloat16),
                        out.data_ptr(), b, n, int(args.bf16_updates), stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        got = x if args.solve else out
        rec[f"{tag}_max_rel_err"] = float((got - want).abs().max()
                                          / want.abs().max())
        rec[f"{tag}_ms"] = ms(call)
        if tag == "instrumented":
            lib.sg_steps_read.argtypes = [ptr, i32]
            if lib.sg_steps_reset():
                raise RuntimeError("resetting the timers failed")
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (SLOTS * b))()
            if lib.sg_steps_read(buf, b):
                raise RuntimeError("reading the timers failed")
            cyc = np.array(buf[:], dtype=np.float64).reshape(b, SLOTS)
            names = dict(enumerate(STEPS))
            names[LAST] = "last_stripe"
            total = cyc.sum(1).mean()
            rec["cycles_per_block"] = total
            rec["steps"] = {
                names.get(k, f"barrier_{k}"): {
                    "kcycles_per_block": cyc[:, k].mean() / 1e3,
                    "share": cyc[:, k].mean() / total,
                    "ms": rec["instrumented_ms"] * cyc[:, k].mean() / total}
                for k in range(SLOTS) if cyc[:, k].any()}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
