#!/usr/bin/env python3
"""Where the ADPCM kernel's time goes: variants of csrc/adpcm.cu on one card.

    python3 tools/adpcm_variants.py

The card's machine has no profiler that reads a kernel's stalls, so this
builds ``speakerguard_tpu_torch/csrc/adpcm.cu`` as it is and copies of it
with one part of the work cut (each by a text substitution that must match
the source, or the tool stops), into a temporary directory, and times each
with CUDA events (one warm-up call, ten timed) on chip_smoke.py's codec
batch (512 x 48,000, uniform in [-0.6, 0.6] from numpy seed 8, scaled to
int16) at 2, 4, 5 and 8 bits, and the fused defense at 4 bits:

- ``as_is``       the source;
- ``chain_only``  the copy warp idles and the chain skips the hand-overs:
                  the recurrence alone, on whatever the stages hold;
- ``copy_only``   the chain only hands the stages over: the copies alone;
- ``no_index``    the table row is always row 0, so no table read waits
                  on the index: the predictor's chain and the selects alone;
- ``copy_4b``     4-byte copies where the source takes 16;
- ``unroll_1``    four samples a loop iteration, not eight.

Prints one JSON line a variant (ms, cycles a sample at 4 bits at the
card's highest SM clock, and for ``as_is``, ``copy_4b`` and ``unroll_1``
whether 4 waves equal the plain loop), then the card's name and power
limit.  Exits non-zero without a card.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "as_is": [],
    "chain_only": [("    bar_sync(full_barrier(s));\n", ""),
                   ("    bar_arrive(done_barrier(s));\n", ""),
                   ("    copier.run();", "")],
    "copy_only": [("      v.x = coder(v.x);\n      v.y = coder(v.y);\n"
                   "      v.z = coder(v.z);\n      v.w = coder(v.w);\n", "")],
    "no_index": [("load_row(__float_as_int(offset) - BIAS_BITS);",
                  "load_row(0 * (__float_as_int(offset) - BIAS_BITS));")],
    "copy_4b": [("  return aligned ? launch_kernel",
                 "  return false ? launch_kernel")],
    "unroll_1": [("#pragma unroll 2\n    for (int t = 0; t < n; t += 4) {",
                  "    for (int t = 0; t < n; t += 4) {")],
}
EXACT = ("as_is", "copy_4b", "unroll_1")


def variant_source(src, subs):
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"adpcm_variants: the source no longer has "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def build(tmp, name, src):
    from speakerguard_tpu_torch.ops import _build
    cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"adpcm_variants: {name} failed to build\n"
                         f"{proc.stderr[-2000:]}")
    return name, so


def main():
    import torch
    if not torch.cuda.is_available():
        print("adpcm_variants: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from speakerguard_tpu_torch.ops import adpcm as A

    def query(field):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    clock_mhz = float(query("clocks.max.sm").split()[0])
    src = (ROOT / "speakerguard_tpu_torch/csrc/adpcm.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = list(pool.map(
                lambda kv: build(Path(tmp), kv[0],
                                 variant_source(src, kv[1])),
                VARIANTS.items()))
        rng = np.random.default_rng(8)
        x = torch.tensor(rng.uniform(-0.6, 0.6, (512, 48000)).astype(
            np.float32), device="cuda")
        x16 = torch.clamp(x * 32768.0, -32768.0, 32767.0)
        lo, hi = torch.aminmax(x)
        out = torch.empty_like(x16)
        stream = torch.cuda.current_stream().cuda_stream
        want = {b: A.adpcm_plain(x16[:4].cpu(), b) for b in (2, 4, 5, 8)}
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, so in built:
            lib = ctypes.CDLL(str(so))
            lib.sg_adpcm.argtypes = [p, p, i, i, i, p]
            lib.sg_adpcm_scaled.argtypes = [p, p, p, p, i, i, i, p]

            def ms(fn):
                fn()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    fn()
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / 10

            rec = {"variant": name}
            for bits in (2, 4, 5, 8):
                rec[f"ms_bits{bits}"] = ms(lambda: lib.sg_adpcm(
                    x16.data_ptr(), out.data_ptr(), 512, 48000, bits, stream))
                if name in EXACT:
                    rec[f"equal_bits{bits}"] = bool(torch.equal(
                        out[:4].cpu(), want[bits]))
            rec["ms_scaled_bits4"] = ms(lambda: lib.sg_adpcm_scaled(
                x.data_ptr(), out.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                512, 48000, 4, stream))
            rec["cycles_per_sample_bits4"] = (rec["ms_bits4"] * 1e-3
                                              * clock_mhz * 1e6 / 48000)
            print(json.dumps(rec), flush=True)
    print(query("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
