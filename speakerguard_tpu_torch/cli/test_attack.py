"""Evaluation CLI (port of speakerguard_tpu/cli/test_attack.py, reference
test_attack.py): accuracy / untargeted & targeted ASR on a (possibly
adversarial) audio directory, plus imperceptibility vs the original
utterances (metrics/metric.py, numpy on the host).  Deterministic unless
``-eval_dither``.

    python -m speakerguard_tpu_torch.cli.test_attack -root DIR -name ADV \\
        [-root_ori DATA -name_ori Spk10_test] [-device cpu] iv_plda ...
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
from speakerguard_tpu_torch.metrics.metric import get_all_metric


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("-threshold", type=float, default=None)
    add_defense_args(parser)
    add_eval_dither_arg(parser)
    parser.add_argument("-root", type=str, required=True)
    parser.add_argument("-name", type=str, required=True)
    parser.add_argument("-root_ori", type=str, default=None)
    parser.add_argument("-name_ori", type=str, default=None)
    parser.add_argument("-wav_length", type=int, default=None)
    parser.add_argument("-batch_size", type=int, default=1)
    parser.add_argument("-target_label_file", default=None)
    add_device_arg(parser)
    add_system_subparsers(parser)
    return parser.parse_args(argv)


@torch.no_grad()
def main(args):
    """Prints what the JAX CLI prints and returns it: {"acc",
    "untargeted_asr", "targeted_asr" (None without a label file),
    "imperceptibility": the means [L2, L0, L1, Linf, SNR, PESQ, STOI] over
    the utterances of finite SNR (None outside that mode), "decisions":
    {utterance: decision}}."""
    base, model, _ = build_model(args)
    spk_ids = base.spk_ids

    wav_length = None if args.batch_size == 1 else args.wav_length
    imper_mode = args.root_ori is not None and args.name_ori is not None
    if imper_mode:
        wav_length = None
        args.batch_size = 1
        warnings.warn("imperceptibility mode: forcing batch_size=1 / "
                      "wav_length=None so ori and adv audio stay aligned")

    dataset = Dataset(spk_ids, args.root, args.name, normalize=True,
                      return_file_name=True, wav_length=wav_length)

    name2ori = {}
    if imper_mode:
        ori = Dataset(spk_ids, args.root_ori, args.name_ori, normalize=True,
                      return_file_name=True, wav_length=None)
        for wavs, _, names in ori.batches(1):
            name2ori[names[0]] = wavs[0]

    name2target = {}
    if args.target_label_file is not None:
        with open(args.target_label_file, "rb") as f:
            name2target = pickle.load(f)

    rngs = eval_rng_stream(args)
    right_cnt = target_success_cnt = total_cnt = 0
    imper, name2decision = [], {}
    for index, (adver, true, names) in enumerate(dataset.batches(
            args.batch_size)):
        decisions, _ = model.make_decision(
            torch.tensor(adver[:, 0, :], device=model.device),
            rng=rngs(index))
        decisions = decisions.cpu().numpy()
        name2decision.update(zip(names, decisions.tolist()))
        right_cnt += int((decisions == true).sum())
        total_cnt += len(true)
        if args.target_label_file is not None:
            target = np.array([name2target[n] for n in names])
            target_success_cnt += int((decisions == target).sum())
        if imper_mode:
            imper.append(get_all_metric(name2ori[names[0]], adver[0]))
        print(f"index: {index} true: {true} decision: {decisions}",
              end="\r")

    print()
    acc = right_cnt * 100 / total_cnt
    out = {"acc": acc, "untargeted_asr": 100.0 - acc, "targeted_asr": None,
           "imperceptibility": None, "decisions": name2decision}
    print("Acc:", acc)
    print("Untargeted Attack Success Rate:", 100.0 - acc)
    if args.target_label_file is not None:
        out["targeted_asr"] = target_success_cnt * 100 / total_cnt
        print("Targeted Attack Success Rate:", out["targeted_asr"])
    if imper_mode:
        imper = [row for row in imper if row[4] != np.inf]
        means = np.mean(np.array(
            [[v if v is not None else np.nan for v in row]
             for row in imper], dtype=np.float64), axis=0)
        out["imperceptibility"] = means.tolist()
        print("L2, SNR, PESQ, STOI: {:.3f} {:.2f} {} {:.3f}".format(
            means[0], means[4],
            "n/a" if np.isnan(means[5]) else f"{means[5]:.2f}", means[6]))
        try:
            import pesq  # noqa: F401
        except ImportError:
            print("note: PESQ/STOI computed by the native implementations "
                  "(metrics/pesq_native.py caveats apply); install "
                  "pesq/pystoi for ITU-certified values")
    return out


if __name__ == "__main__":
    main(parse_args())
