#!/usr/bin/env python3
"""chip_smoke.py's checks of stats_bwd's three launches, run on the port
of another checkout, for comparing two versions of csrc/gmm_stats_bwd.cu
in one call to the card.

    python3 tools/stats_bwd_launches.py [--root DIR]

Imports ``speakerguard_tpu_torch`` from DIR (default: the checkout holding
this script) and ``phase_stats_bwd_launches`` from the chip_smoke.py beside
this script, builds DIR's stats kernels, and runs the phase: each launch
against its plain version at every shape of BWD_SHAPES (main, ragged, and
the defended iv slice's 64 x 150 frames), with its CUDA-event ms at the
main shape and the direct term's error against a float64 product.  Prints
the phase's JSON lines; a launch outside its bar is printed and the script
exits 2 after the lines it reached.  Exits 1 without a card.
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("stats_bwd_launches: no CUDA card visible to torch",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import speakerguard_tpu_torch  # noqa: F401  (TF32 off)
    from speakerguard_tpu_torch.ops import _build
    if not speakerguard_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {speakerguard_tpu_torch.__file__}, "
                           f"not the port under {root}")
    for src in ("gmm_stats_fwd", "gmm_stats_bwd"):
        _build.build(src)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    try:
        smoke.phase_stats_bwd_launches(torch)
    except RuntimeError as exc:
        print(f"stats_bwd_launches: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
