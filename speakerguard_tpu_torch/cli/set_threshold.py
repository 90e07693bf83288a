"""EER-based threshold selection CLI (port of
speakerguard_tpu/cli/set_threshold.py, reference set_threshold.py): sweeps
candidate thresholds over the target scores, picks min |FRR - FAR|,
reports SV/OSI thresholds + EER (+ OSI IER and CSI-E accuracy).

    python -m speakerguard_tpu_torch.cli.set_threshold -root DATA \\
        [-device cpu] iv_plda ... -model_file FILE
"""

import numpy as np
import torch

from speakerguard_tpu_torch.cli.common import (add_defense_args,
                                               add_device_arg,
                                               add_eval_dither_arg,
                                               add_system_subparsers,
                                               build_model, eval_rng_stream)
from speakerguard_tpu_torch.data.dataset import Spk10_test, Spk10_imposter


def set_threshold(score_target, score_untarget):
    """Reference set_threshold.py:22-47 verbatim semantics, vectorized."""
    score_target = np.asarray(score_target)
    score_untarget = np.asarray(score_untarget)
    frr = (score_target[None, :] <
           score_target[:, None]).sum(1) * 100 / score_target.size
    far = (score_untarget[None, :] >=
           score_target[:, None]).sum(1) * 100 / score_untarget.size
    diff = np.abs(frr - far)
    i = int(np.argmin(diff))
    return float(score_target[i]), float(frr[i]), float(far[i])


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("-root", default="./data")
    add_defense_args(parser)
    add_eval_dither_arg(parser)
    add_device_arg(parser)
    add_system_subparsers(parser)
    return parser.parse_args(argv)


def _decide(model, wavs, rng):
    """(decision, scores as a numpy row) of one (1, 1, L) utterance."""
    d, s = model.make_decision(
        torch.tensor(wavs[:, 0, :], device=model.device), rng=rng)
    return int(d[0]), s.cpu().numpy().flatten()


@torch.no_grad()
def main(args):
    base, model, _ = build_model(args)
    spk_ids = base.spk_ids

    test = Spk10_test(spk_ids, args.root, return_file_name=True)
    imposter = Spk10_imposter(spk_ids, args.root, return_file_name=True)

    rngs = eval_rng_stream(args)
    score_target_sv, score_untarget_sv = [], []
    score_target_osi, score_untarget_osi = [], []
    trues, max_scores, decisions = [], [], []
    acc_cnt = 0
    for i, (wavs, true, names) in enumerate(test.batches(1)):
        d, s = _decide(model, wavs, rngs(i))
        t = int(true[0])
        print(names[0], s, t, d)
        score_target_sv.append(s[t])
        score_untarget_sv += np.delete(s, t).tolist()
        if d == t:
            score_target_osi.append(s[t])
            acc_cnt += 1
        trues.append(t)
        max_scores.append(float(s.max()))
        decisions.append(d)

    for i, (wavs, true, names) in enumerate(imposter.batches(1)):
        d, s = _decide(model, wavs, rngs(len(test) + i))
        print(names[0], s, int(true[0]), d)
        score_untarget_sv += s.tolist()
        score_untarget_osi.append(float(s.max()))

    thr_sv, frr, far = set_threshold(score_target_sv, score_untarget_sv)
    eer_sv = max(frr, far)
    print(f"----- Test of {args.system_type}-based SV, result ---> "
          f"threshold: {thr_sv:.2f} EER: {eer_sv:.2f}")

    thr_osi, frr, far = set_threshold(score_target_osi, score_untarget_osi)
    eer_osi = max(frr, far)
    max_scores = np.asarray(max_scores)
    decisions = np.asarray(decisions)
    trues_a = np.asarray(trues)
    ier_cnt = int(np.sum((max_scores >= thr_osi) & (decisions != trues_a)))
    ier = ier_cnt * 100 / len(trues)
    print(f"----- Test of {args.system_type}-based OSI, result ---> "
          f"threshold: {thr_osi:.2f}, EER: {eer_osi:.2f}, "
          f"IER: {ier:.2f} -----")
    csi_acc = acc_cnt * 100 / len(test)
    print("CSI ACC:", csi_acc)
    # returned for programmatic use
    return {"sv_threshold": thr_sv, "sv_eer": eer_sv,
            "osi_threshold": thr_osi, "osi_eer": eer_osi, "osi_ier": ier,
            "csi_acc": csi_acc}


if __name__ == "__main__":
    main(parse_args())
