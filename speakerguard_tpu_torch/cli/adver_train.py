"""Adversarial training CLI for AudioNet CSI-NE.

Port of speakerguard_tpu/cli/adver_train.py (reference adver_train.py):
each step replaces ``-ratio`` of its batch with FGSM or PGD examples made
against the live parameters (``models/training.py``'s adversarial step),
and reports the accuracy on the adversarial and on the clean rows.  An
epoch's mean skips the nan that a batch with no adversarial row reports
(``nanmean``), as in JAX.  ``-evaluate_adver`` adds the accuracy under the
same attack on up to 50 validation waves of 32,000 samples.

It differs from the JAX CLI as ``cli/natural_train.py`` does: ``-device``,
the step's draws (``main(args, draws=)``; the attack draws nothing),
``-n_devices`` (the adversarial rows are the first
``int(B * ratio)`` of the global batch), ``-ckpt_backend dcp``.  Unlike
natural_train, it does not write a missing label encoder (as in JAX).
"""

import time

import numpy as np
import torch

from speakerguard_tpu_torch.cli.common import cli_device
from speakerguard_tpu_torch.cli.natural_train import (add_train_args,
                                                      file_logger, setup,
                                                      step_generator,
                                                      train_batches,
                                                      validate)
from speakerguard_tpu_torch.data.dataset import Spk251_test, Spk251_train
from speakerguard_tpu_torch.models.audionet import (audionet_logits,
                                                    parse_label_encoder)
from speakerguard_tpu_torch.models.training import (make_adver_train_step,
                                                    make_pgd_for_training)
from speakerguard_tpu_torch.ops.logmel import audionet_logmel
from speakerguard_tpu_torch.optim import Adam
from speakerguard_tpu_torch.parallel.mesh import (is_rank0, launch,
                                                  rank_device)


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    add_train_args(parser, "./model_file/audionet-adver")
    # attacker (reference adver_train.py: FGSM or PGD)
    parser.add_argument("-attacker", default="PGD",
                        choices=["FGSM", "PGD"])
    parser.add_argument("-epsilon", type=float, default=0.002)
    parser.add_argument("-step_size", type=float, default=0.0004)
    parser.add_argument("-max_iter", type=int, default=10)
    parser.add_argument("-ratio", type=float, default=0.5)
    parser.add_argument("-evaluate_adver", action="store_true",
                        default=False)
    return parser.parse_args(argv)


def validate_adver(params, state, spk_ids, root, attack, wav_length=32000,
                   max_utts=50):
    """Adversarial validation (reference adver_train.py:85-101): attack
    validation waves against the current parameters, in batches of 8, and
    report the accuracy on the adversarial waves."""
    val = Spk251_test(spk_ids, root, wav_length=wav_length)
    device = params.fc_w.device
    right = total = 0
    for wavs, labels in val.batches(8, drop_last=True):
        if total >= max_utts:
            break
        x = torch.tensor(wavs[:, 0, :], device=device)
        y = torch.tensor(labels, device=device)
        adv = attack(params, state, x, y)
        with torch.no_grad():
            logits, _, _ = audionet_logits(params, state,
                                           audionet_logmel(adv))
        right += int((torch.argmax(logits, -1) == y).sum())
        total += len(labels)
    return right / max(total, 1)


def make_attack(args):
    if args.attacker == "FGSM":
        return make_pgd_for_training(epsilon=args.epsilon,
                                     step_size=args.epsilon, max_iter=1)
    return make_pgd_for_training(epsilon=args.epsilon,
                                 step_size=args.step_size,
                                 max_iter=args.max_iter)


def run(args, draws=None):
    """One rank's run; returns what natural_train's ``run`` returns, with
    ``accs_adv`` / ``accs_nor`` (per batch), ``epoch_accs`` as pairs
    (adversarial, normal) and ``val_adver_accs``."""
    device = rank_device(cli_device(args))
    rng = np.random.default_rng(args.seed)
    spk_ids = parse_label_encoder(args.label_encoder)
    params, state, opt_state, ckpt, mesh, wrap = setup(args, rng,
                                                       len(spk_ids), device)
    attack = make_attack(args)
    step = wrap(make_adver_train_step(Adam(args.lr), attack,
                                      ratio=args.ratio, aug_eps=args.aug_eps,
                                      compute_dtype=args.precision))
    train = Spk251_train(spk_ids, args.root, wav_length=args.wav_length,
                         seed=args.seed)
    rank0 = is_rank0()
    ckpt_base = args.model_ckpt or "./model_file/audionet-adver"
    logger = file_logger("speakerguard_tpu_torch.adver_train",
                         args.log or f"{ckpt_base}.log")
    gen = step_generator(args, device)
    out = {"losses": [], "accs_adv": [], "accs_nor": [], "labels": [],
           "step_s": [], "epoch_accs": [], "val_accs": [],
           "val_adver_accs": []}
    n_steps = 0
    for i_epoch in range(args.num_epoches):
        accs_adv, accs_nor = [], []
        for batch_id, (wavs, labels) in enumerate(
                train_batches(train, args, mesh, device)):
            t0 = time.time()
            params, state, opt_state, loss, acc_adv, acc_nor = step(
                params, state, opt_state, wavs, labels, rng=gen,
                draw_fn=draws(n_steps) if draws else None)
            n_steps += 1
            accs_adv.append(float(acc_adv))
            accs_nor.append(float(acc_nor))
            out["losses"].append(float(loss))
            out["step_s"].append(time.time() - t0)
            out["labels"].append(labels.tolist())
            if rank0:
                print(f"Batch {batch_id}: loss={float(loss):.4f} "
                      f"acc_adv={float(acc_adv):.4f} "
                      f"acc_normal={float(acc_nor):.4f} "
                      f"time={out['step_s'][-1]:.3f}s", end="\r")
        out["accs_adv"] += accs_adv
        out["accs_nor"] += accs_nor
        epoch = i_epoch + args.start_epoch
        mean_adv, mean_nor = np.nanmean(accs_adv), np.nanmean(accs_nor)
        out["epoch_accs"].append((float(mean_adv), float(mean_nor)))
        if rank0:
            print(f"\nEPOCH {epoch}: Acc adv = {mean_adv:.4f} "
                  f"Acc normal = {mean_nor:.4f}")
        logger.info("EPOCH %d/%d: Acc adv = %.6f Acc normal = %.6f", epoch,
                    args.num_epoches + args.start_epoch, mean_adv, mean_nor)
        ckpt.save(f"{ckpt_base}_{epoch}", params, state, opt_state, epoch)
        if rank0 and args.evaluate_per_epoch > 0 and \
                i_epoch % args.evaluate_per_epoch == 0:
            val_acc = validate(params, state, spk_ids, args.root)
            out["val_accs"].append(val_acc)
            msg = "Val Acc: %f" % val_acc
            if args.evaluate_adver:
                adv_acc = validate_adver(params, state, spk_ids, args.root,
                                         attack)
                out["val_adver_accs"].append(adv_acc)
                msg += ", Val Adver Acc: %f" % adv_acc
            print(msg)
            logger.info("%s", msg)
    ckpt.save(ckpt_base, params, state, opt_state,
              args.num_epoches + args.start_epoch, wait=True)
    return out


def main(args, draws=None):
    """Trains; returns rank 0's ``run`` result.  ``draws`` (one process
    only) gives each step's draws."""
    if args.n_devices > 1:
        if draws is not None:
            raise ValueError("draws= is for a one-process run")
        return launch(run, args, args.n_devices, cli_device(args))
    return run(args, draws)


if __name__ == "__main__":
    main(parse_args())
