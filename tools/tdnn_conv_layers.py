#!/usr/bin/env python3
"""chip_smoke.py's ``tdnn_conv`` phase alone: csrc/tdnn_conv.cu at the xv
headline shape (512 x 300 frames), each layer's forward and backward
launch timed alone, through its wrapper, beside the present im2col +
cuBLAS block and fast_block_plain, with its bound and a check against the
im2col block.

    python3 tools/tdnn_conv_layers.py [--root DIR]

Imports ``speakerguard_tpu_torch`` from DIR (default: the checkout holding
this script), builds its csrc/tdnn_conv.cu, prints nvcc's register and
spill lines and the phase's JSON lines (the last one the sums over a PGD-10
call).  Exits 2 when a layer is off its bars, 1 without a card.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("tdnn_conv_layers: no CUDA card visible to torch",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import speakerguard_tpu_torch  # noqa: F401  (TF32 off)
    from speakerguard_tpu_torch.ops import _build
    if not speakerguard_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {speakerguard_tpu_torch.__file__}, "
                           f"not the port under {root}")
    log = _build.build("tdnn_conv")
    print(json.dumps({"phase": "build", "ptxas": [
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln]}),
        flush=True)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    try:
        smoke.phase_tdnn_conv(torch)
    except RuntimeError as exc:
        print(f"tdnn_conv_layers: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
