"""Target-label selection CLI (port of
speakerguard_tpu/cli/specify_target_label.py, reference
specify_target_label.py): pre-computes per-utterance target labels
(random / hardest = lowest-score / simplest = highest-score) into a pickle
consumed by attack_main/test_attack.  The random choice is numpy's
``default_rng(seed)`` in the JAX CLI's order, so both packages pick the
same targets from the same decisions.

    python -m speakerguard_tpu_torch.cli.specify_target_label -root DATA \\
        -name Spk10_test [-hardest | -simplest] [-device cpu] iv_plda ...
"""

import pickle
import warnings

import numpy as np
import torch

from speakerguard_tpu_torch.cli.common import (add_defense_args,
                                               add_device_arg,
                                               add_eval_dither_arg,
                                               add_system_subparsers,
                                               build_model, eval_rng_stream)
from speakerguard_tpu_torch.data.dataset import Dataset


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("-root", required=True)
    parser.add_argument("-name", required=True)
    parser.add_argument("-save_path", default=None)
    parser.add_argument("-hardest", action="store_true", default=False)
    parser.add_argument("-simplest", action="store_true", default=False)
    parser.add_argument("-threshold", type=float, default=None)
    parser.add_argument("-task", type=str, default="CSI",
                        choices=["CSI", "SV", "OSI"])
    parser.add_argument("-seed", type=int, default=0)
    add_defense_args(parser)
    add_eval_dither_arg(parser)
    add_device_arg(parser)
    add_system_subparsers(parser)
    return parser.parse_args(argv)


@torch.no_grad()
def main(args):
    base, model, defense_name = build_model(args)
    spk_ids = base.spk_ids
    possible = list(range(len(spk_ids)))
    if args.task in ("SV", "OSI"):
        possible.append(-1)

    if args.task == "SV":
        args.hardest = False
    if args.hardest and args.simplest:
        args.hardest = args.simplest = False
        warnings.warn("both hardest and simplest set; rolling back to random")

    rng = np.random.default_rng(args.seed)
    dataset = Dataset(spk_ids, args.root, args.name, normalize=True,
                      return_file_name=True)
    rngs = eval_rng_stream(args)
    name2target = {}
    for index, (wavs, true, names) in enumerate(dataset.batches(1)):
        d, s = model.make_decision(
            torch.tensor(wavs[:, 0, :], device=model.device),
            rng=rngs(index))
        decision = int(d[0])
        scores = s.cpu().numpy().flatten()
        t = int(true[0])
        cands = [i for i in possible if i != t and i != decision]
        cand_scores = [sc for i, sc in enumerate(scores)
                       if i != t and i != decision]
        if not cands:
            cands = [i for i in possible if i != decision]
        if not cand_scores:
            cand_scores = [sc for i, sc in enumerate(scores)
                           if i != decision]
        if not args.hardest and not args.simplest:
            target = int(rng.choice(cands))
        else:
            if -1 in cands:
                cands.remove(-1)
            target = (cands[int(np.argmin(cand_scores))] if args.hardest
                      else cands[int(np.argmax(cand_scores))])
        name2target[names[0]] = target
        print(index, names[0], scores, t, decision, target)

    save_path = args.save_path or (
        f"{args.system_type}-{args.task}-{defense_name}-{args.name}-"
        f"{args.hardest}.target_label")
    with open(save_path, "wb") as f:
        pickle.dump(name2target, f, -1)
    print(f"saved name->target pairs in {save_path}")


if __name__ == "__main__":
    main(parse_args())
