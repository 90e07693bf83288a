#!/usr/bin/env python3
"""natural_train with -n_devices N on N cards against -n_devices 1.

    python3 tools/train_cli_cards.py [--n N] [--device cuda|cpu]
                                     [--classes C] [--length L]
                                     [--batch B] [--epochs E]

Writes a synthetic Spk251_train tree (C speakers, one WAV each of L +
16,000 samples and a second one for the first few, numpy seed 3: B
ceil(C / B) WAVs, so that every batch is full and N ranks drop no
ragged tail) in a temporary directory, then runs the port's
natural_train (AudioNet, Adam 1e-3, augmentation on, no validation) for E
epochs twice: in this process with -n_devices 1, and on N ranks through
``parallel.mesh.launch`` (spawned, rank r on cuda:r under nccl; gloo on
the CPU), where each rank runs ``natural_train.run`` and reports its
device and the memory its process holds on each card.  Prints one JSON
line: both runs' per-batch losses and accuracies, their largest relative
gap, each rank's report, the card's name and power limit.  Exits
non-zero when a rank ran on another card than its own, held memory on
another card, a loss is not finite, the runs' step counts differ, or
their first losses (before any update) differ by more than 1e-5
relative.  Defaults: N = the cards visible, the JAX bench's width (251
classes, batch 128 of 80,000 samples), 2 epochs.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def write_world(root, classes, samples, batch):
    from speakerguard_tpu_torch.utils.audio_io import write_wav
    rng = np.random.default_rng(3)
    extra = batch * -(-classes // batch) - classes
    for i in range(classes):
        d = os.path.join(root, "Spk251_train", f"spk{i:03d}")
        os.makedirs(d)
        for u in range(2 if i < extra else 1):
            write_wav(os.path.join(d, f"u{u}.wav"), (rng.standard_normal(
                samples) * 0.1).astype(np.float32))


def rank_run(args):
    """natural_train.run on this rank, and what each rank saw: its device
    and the bytes its process holds on each card (gathered to every
    rank)."""
    import torch
    import torch.distributed as dist
    from speakerguard_tpu_torch.cli import natural_train
    from speakerguard_tpu_torch.cli.common import cli_device
    from speakerguard_tpu_torch.parallel.mesh import rank_device
    out = natural_train.run(args)
    device = rank_device(cli_device(args))
    report = {"rank": dist.get_rank(), "device": str(device),
              "reserved_bytes": [torch.cuda.memory_reserved(i) for i in
                                 range(torch.cuda.device_count())]
              if device.type == "cuda" else []}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, report)
    out["ranks"] = ranks
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--classes", type=int, default=251)
    ap.add_argument("--length", type=int, default=80_000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=2)
    opt = ap.parse_args(argv)
    import torch
    from speakerguard_tpu_torch.cli import natural_train
    from speakerguard_tpu_torch.parallel.mesh import launch
    if opt.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    n = opt.n or (torch.cuda.device_count() if opt.device == "cuda" else 2)
    card = None
    if opt.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    with tempfile.TemporaryDirectory() as root:
        write_world(root, opt.classes, opt.length + 16_000, opt.batch)
        runs = {}
        for tag, n_dev in (("one", 1), ("ranks", n)):
            argv = ["-root", root, "-label_encoder",
                    os.path.join(root, "label_encoder.txt"),
                    "-batch_size", str(opt.batch), "-wav_length",
                    str(opt.length), "-num_epoches", str(opt.epochs),
                    "-evaluate_per_epoch", "0", "-model_ckpt",
                    os.path.join(root, f"ckpt_{tag}", "audionet"),
                    "-n_devices", str(n_dev), "-device", opt.device]
            args = natural_train.parse_args(argv)
            if n_dev == 1:
                natural_train.write_label_encoder_if_absent(args)
                runs[tag] = natural_train.run(args)
            else:
                runs[tag] = launch(rank_run, args, n_dev, opt.device)
    one, ranks = runs["one"], runs["ranks"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(ranks["losses"],
                                                  one["losses"]))
    own = [r["device"] == (f"cuda:{r['rank']}" if opt.device == "cuda"
                           else opt.device) for r in ranks["ranks"]]
    foreign = [sum(b for i, b in enumerate(r["reserved_bytes"])
                   if i != r["rank"]) for r in ranks["ranks"]]
    rec = {"tool": "train_cli_cards", "n_devices": n, "device": opt.device,
           "classes": opt.classes, "batch": opt.batch,
           "samples": opt.length, "epochs": opt.epochs,
           "losses_one": one["losses"], "losses_ranks": ranks["losses"],
           "accs_one": one["accs"], "accs_ranks": ranks["accs"],
           "loss_max_rel_gap": gap,
           "step_s_one": one["step_s"], "step_s_ranks": ranks["step_s"],
           "ranks": ranks["ranks"], "on_own_card": own,
           "bytes_on_other_cards": foreign, "card": card}
    print(json.dumps(rec))
    ok = (len(ranks["losses"]) == len(one["losses"])
          and np.isfinite(ranks["losses"]).all() and all(own)
          and abs(ranks["losses"][0] - one["losses"][0])
          <= 1e-5 * abs(one["losses"][0])
          and not any(foreign) and len(ranks["ranks"]) == n)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
