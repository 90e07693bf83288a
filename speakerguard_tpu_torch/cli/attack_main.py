"""Attack-generation CLI (port of speakerguard_tpu/cli/attack_main.py,
reference attackMain.py).

Same grammar: `python -m speakerguard_tpu_torch.cli.attack_main <common
args> <system_type> <model args> <ATTACK> <attack args>`; same artifact
layout (adver-audio/<system>-<task>-<name>/<defense>/<attack>/...),
resume-by-skip, FAKEBOB threshold estimation for black-box SV/OSI,
targeted-label files (else targets from numpy's ``default_rng(seed)`` in
the JAX CLI's order).

Where it differs from the JAX CLI:
  * ``-device`` (default cuda) places the model and every batch
    (cli/common.py); without a CUDA device it raises unless given
    ``-device cpu``.
  * The attack's randomness per batch is a torch.Generator on the device
    seeded from (seed, batch index) (``common.seeded_generator``), where
    JAX folds the batch index into ``PRNGKey(seed)``: the draws differ.
    The attacks' draw hooks (``PGD(init_noise_fn=, dither_fn=)``) take
    another source of draws.
  * ``-n_devices N > 1`` with FGSM, PGD or CWinf runs N ranks
    (``parallel.mesh.launch``: spawned from a plain process, rank r on
    ``cuda:r``, or one each under ``torchrun``), joined with nccl on cuda
    and gloo on the CPU; the attack
    gets the mesh, as the JAX CLI's does, and splits each batch over the
    ranks (attacks/base.py).  Every rank reads the whole batch; rank 0
    decides the skips, writes the waves and prints the success rate, and
    ``main`` returns its result.  The other attacks ignore it, as in the
    JAX CLI.
  * ``-EOT_batch_size`` is parsed and passed nowhere, exactly as in the
    JAX CLI (its make_attacker never reads it).
"""

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from speakerguard_tpu_torch.attacks import (FGSM, PGD, CWinf, CW2, FAKEBOB,
                                            SirenAttack, Kenan)
from speakerguard_tpu_torch.cli.common import (add_defense_args,
                                               add_device_arg,
                                               add_system_subparsers,
                                               build_model, cli_device,
                                               seeded_generator)
from speakerguard_tpu_torch.data.dataset import Dataset
from speakerguard_tpu_torch.parallel.mesh import is_rank0, launch, make_mesh
from speakerguard_tpu_torch.utils.audio_io import read_wav, write_wav

BLACK_BOX_ATTACKS = ("FAKEBOB", "SirenAttack")
SHARDED_ATTACKS = ("FGSM", "PGD", "CWinf")


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser()

    parser.add_argument("-threshold", type=float, default=None)
    parser.add_argument("-threshold_estimated", type=float, default=None)
    parser.add_argument("-thresh_est_wav_path", type=str, nargs="+",
                        default=None)
    parser.add_argument("-thresh_est_step", type=float, default=0.1)
    add_defense_args(parser)
    parser.add_argument("-root", type=str, required=True)
    parser.add_argument("-name", type=str, required=True)
    parser.add_argument("-des", type=str, default=None)
    parser.add_argument("-task", type=str, default="CSI",
                        choices=["CSI", "SV", "OSI"])
    parser.add_argument("-wav_length", type=int, default=None)
    parser.add_argument("-targeted", action="store_true", default=False)
    parser.add_argument("-target_label_file", default=None)
    parser.add_argument("-batch_size", type=int, default=1)
    parser.add_argument("-EOT_size", type=int, default=1)
    parser.add_argument("-EOT_batch_size", type=int, default=1)
    parser.add_argument("-start", type=int, default=0)
    parser.add_argument("-end", type=int, default=-1)
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-n_devices", type=int, default=1,
                        help="shard each attack batch over a 'data' mesh "
                             "of this many ranks (white-box attacks)")
    add_device_arg(parser)

    systems = add_system_subparsers(parser)
    for sp in systems:
        sub = sp.add_subparsers(dest="attacker")

        f = sub.add_parser("FGSM")
        f.add_argument("-epsilon", type=float, default=0.002)
        f.add_argument("-loss", choices=["Entropy", "Margin"],
                       default="Entropy")

        p = sub.add_parser("PGD")
        p.add_argument("-step_size", type=float, default=0.0004)
        p.add_argument("-epsilon", type=float, default=0.002)
        p.add_argument("-max_iter", type=int, default=10)
        p.add_argument("-num_random_init", type=int, default=0)
        p.add_argument("-loss", choices=["Entropy", "Margin"],
                       default="Entropy")

        ci = sub.add_parser("CWinf")
        ci.add_argument("-step_size", type=float, default=0.001)
        ci.add_argument("-epsilon", type=float, default=0.002)
        ci.add_argument("-max_iter", type=int, default=10)
        ci.add_argument("-num_random_init", type=int, default=0)

        c2 = sub.add_parser("CW2")
        c2.add_argument("-initial_const", type=float, default=1e-3)
        c2.add_argument("-binary_search_steps", type=int, default=9)
        c2.add_argument("-max_iter", type=int, default=10000)
        c2.add_argument("-stop_early", action="store_false", default=True)
        c2.add_argument("-stop_early_iter", type=int, default=1000)
        c2.add_argument("-lr", type=float, default=1e-2)
        c2.add_argument("-confidence", type=float, default=0.0)

        fb = sub.add_parser("FAKEBOB")
        fb.add_argument("-confidence", type=float, default=0.0)
        fb.add_argument("-epsilon", type=float, default=0.002)
        fb.add_argument("-max_iter", type=int, default=1000)
        fb.add_argument("-max_lr", type=float, default=0.001)
        fb.add_argument("-min_lr", type=float, default=1e-6)
        fb.add_argument("-samples", dest="samples_per_draw", type=int,
                        default=50)
        fb.add_argument("-samples_batch", type=int, default=50)
        fb.add_argument("-sigma", type=float, default=0.001)
        fb.add_argument("-momentum", type=float, default=0.9)
        fb.add_argument("-plateau_length", type=int, default=5)
        fb.add_argument("-plateau_drop", type=float, default=2.0)
        fb.add_argument("-stop_early", action="store_false", default=True)
        fb.add_argument("-stop_early_iter", type=int, default=100)

        si = sub.add_parser("SirenAttack")
        si.add_argument("-confidence", type=float, default=0.0)
        si.add_argument("-epsilon", type=float, default=0.002)
        si.add_argument("-max_epoch", type=int, default=30)
        si.add_argument("-max_iter", type=int, default=300)
        si.add_argument("-c1", type=float, default=1.4961)
        si.add_argument("-c2", type=float, default=1.4961)
        si.add_argument("-n_particles", type=int, default=50)
        si.add_argument("-w_init", type=float, default=0.9)
        si.add_argument("-w_end", type=float, default=0.1)

        kn = sub.add_parser("kenan")
        kn.add_argument("-atk_name", default="fft", choices=["fft", "ssa"])
        kn.add_argument("-raster_width", type=int, default=100)
        kn.add_argument("-max_iter", type=int, default=15)
        kn.add_argument("-early_stop", type=int, default=0)

    return parser.parse_args(argv)


def make_attacker(args, model):
    common = dict(targeted=args.targeted, batch_size=args.batch_size)
    if getattr(args, "n_devices", 1) > 1 and args.attacker in \
            SHARDED_ATTACKS:
        common["mesh"] = make_mesh(args.n_devices, axes=("data",),
                                   device_type=model.device.type)
    if args.attacker == "FGSM":
        return FGSM(model, task=args.task, epsilon=args.epsilon,
                    loss=args.loss, EOT_size=args.EOT_size, **common)
    if args.attacker == "PGD":
        return PGD(model, task=args.task, epsilon=args.epsilon,
                   step_size=args.step_size, max_iter=args.max_iter,
                   num_random_init=args.num_random_init, loss=args.loss,
                   EOT_size=args.EOT_size, **common)
    if args.attacker == "CWinf":
        return CWinf(model, task=args.task, epsilon=args.epsilon,
                     step_size=args.step_size, max_iter=args.max_iter,
                     num_random_init=args.num_random_init,
                     EOT_size=args.EOT_size, **common)
    if args.attacker == "CW2":
        return CW2(model, task=args.task, initial_const=args.initial_const,
                   binary_search_steps=args.binary_search_steps,
                   max_iter=args.max_iter, stop_early=args.stop_early,
                   stop_early_iter=args.stop_early_iter, lr=args.lr,
                   confidence=args.confidence, **common)
    if args.attacker == "FAKEBOB":
        return FAKEBOB(model, threshold=args.threshold_estimated,
                       task=args.task, confidence=args.confidence,
                       epsilon=args.epsilon, max_iter=args.max_iter,
                       max_lr=args.max_lr, min_lr=args.min_lr,
                       samples_per_draw=args.samples_per_draw,
                       samples_per_draw_batch_size=args.samples_batch,
                       sigma=args.sigma, momentum=args.momentum,
                       plateau_length=args.plateau_length,
                       plateau_drop=args.plateau_drop,
                       stop_early=args.stop_early,
                       stop_early_iter=args.stop_early_iter,
                       EOT_size=args.EOT_size, **common)
    if args.attacker == "SirenAttack":
        return SirenAttack(model, threshold=args.threshold_estimated,
                           task=args.task, confidence=args.confidence,
                           epsilon=args.epsilon, max_epoch=args.max_epoch,
                           max_iter=args.max_iter, c1=args.c1, c2=args.c2,
                           n_particles=args.n_particles, w_init=args.w_init,
                           w_end=args.w_end, EOT_size=args.EOT_size,
                           **common)
    if args.attacker == "kenan":
        # the whole batch runs at once: Kenan takes no batch_size
        return Kenan(model, atk_name=args.atk_name, max_iter=args.max_iter,
                     raster_width=args.raster_width, targeted=args.targeted,
                     early_stop=bool(args.early_stop))
    raise NotImplementedError("Not Supported Attack Algorithm")


def attacker_param_tag(args):
    if args.attacker == "FGSM":
        return [args.epsilon, args.EOT_size]
    if args.attacker == "PGD":
        return [args.max_iter, args.epsilon, args.step_size,
                args.num_random_init, args.EOT_size]
    if args.attacker == "CWinf":
        return [args.max_iter, args.epsilon, args.num_random_init,
                args.EOT_size]
    if args.attacker == "CW2":
        return [args.initial_const, args.confidence, args.max_iter,
                args.stop_early_iter]
    if args.attacker == "FAKEBOB":
        return [args.epsilon, args.confidence, args.samples_per_draw,
                args.max_iter, args.stop_early_iter]
    if args.attacker == "SirenAttack":
        return [args.epsilon, args.confidence, args.max_epoch, args.max_iter]
    if args.attacker == "kenan":
        return f"{args.atk_name}-{args.max_iter}"
    raise NotImplementedError


def main(args):
    """Runs the attack over the dataset and writes the adversarial WAVs.
    Returns {"adver_dir", "success": {utterance: bool} of the batches
    attacked in this run, "success_rate" (None when every batch was
    skipped), "attack_s": wall seconds inside the attack calls}; with
    ``-n_devices`` > 1, rank 0's."""
    if args.n_devices > 1 and args.attacker in SHARDED_ATTACKS:
        return launch(run, args, args.n_devices, cli_device(args))
    return run(args)


def _skip(path, dev) -> bool:
    """Whether the batch's first wave exists, as rank 0 sees it (one
    decision for every rank)."""
    flag = torch.tensor([int(os.path.exists(path))], device=dev)
    if dist.is_initialized():
        dist.broadcast(flag, src=0)
    return bool(flag)


def run(args):
    """One rank's attack run (the whole run without -n_devices)."""
    rank0 = is_rank0()
    base, model, defense_name = build_model(args)
    dev = model.device
    spk_ids = base.spk_ids

    wav_length = None if args.batch_size == 1 else args.wav_length
    dataset = Dataset(spk_ids, args.root, args.name, normalize=True,
                      return_file_name=True, wav_length=wav_length)

    # black-box threshold handling
    if args.task in ("SV", "OSI") and args.attacker in BLACK_BOX_ATTACKS:
        if args.attacker == "SirenAttack" and args.threshold_estimated is None:
            raise NotImplementedError(
                "SirenAttack has no threshold estimation; run FAKEBOB first")
        if args.attacker == "FAKEBOB" and args.threshold_estimated is None:
            fakebob = make_attacker(args, model)
            assert args.thresh_est_wav_path is not None
            estimates = []
            print("===== Estimating threshold using FAKEBOB =====")
            for path in args.thresh_est_wav_path:
                wav = torch.tensor(read_wav(path)[None, :], device=dev)
                est = fakebob.estimate_threshold(wav, args.thresh_est_step)
                if est is not None:
                    estimates.append(est)
            assert estimates, "no imposter audio usable for estimation"
            args.threshold_estimated = float(np.mean(estimates))
            print(f"===== Estimated threshold: {args.threshold_estimated}, "
                  f"differ with true threshold: "
                  f"{abs(model.threshold - args.threshold_estimated)} =====")

    attacker = make_attacker(args, model)
    adver_dir = args.des or (
        f"./adver-audio/{args.system_type}-{args.task}-{args.name}/"
        f"{defense_name}/{args.attacker}/"
        f"{args.attacker}-{attacker_param_tag(args)}")
    if rank0:
        print(adver_dir)

    name2target = {}
    if args.target_label_file is not None:
        with open(args.target_label_file, "rb") as f:
            name2target = pickle.load(f)

    batches = list(dataset.batches(args.batch_size))
    start = min(max(args.start, 0), len(batches))
    end = len(batches) if args.end == -1 else min(max(args.end, 0),
                                                  len(batches))
    rng = np.random.default_rng(args.seed)

    name2success, attack_s = {}, 0.0
    for index, (origin, true, names) in enumerate(batches):
        if not (start <= index < end):
            continue
        des_path = os.path.join(adver_dir, names[0].split("-")[0],
                                names[0] + ".wav")
        if _skip(des_path, dev):
            if rank0:
                print("*" * 40, index, names[0], "Exists, Skip", "*" * 40)
            continue
        # Attacks operate in the scale domain.  Dataset(normalize=True)
        # already yields it (reference attackMain.py:188-189 feeds the
        # loader output to attacks directly) — only an origin-domain
        # dataset needs the one-time divide; a mis-scaled array is then
        # rejected loudly by the attack entry (assert_scale_domain).
        origin = origin.astype(np.float32)
        if dataset.domain == "origin":
            origin = origin / (2.0 ** 15)
        if args.targeted:
            target = true.copy()
            for ii, y in enumerate(true):
                if names[ii] in name2target:
                    target[ii] = name2target[names[ii]]
                else:
                    cands = list(range(len(spk_ids)))
                    if args.task in ("SV", "OSI"):
                        cands.append(-1)
                    if y in cands:
                        cands.remove(y)
                    target[ii] = rng.choice(cands)
            true = target
        if rank0:
            print("*" * 10, index, "*" * 10)
        t0 = time.perf_counter()
        adver, success = attacker.attack(
            torch.tensor(origin, device=dev), true,
            rng=seeded_generator(dev, args.seed, index))
        attack_s += time.perf_counter() - t0
        adver = adver.cpu().numpy()
        for adv_i, name, ok in zip(adver[:, 0, :], names, success):
            if rank0:
                spk_dir = os.path.join(adver_dir, name.split("-")[0])
                os.makedirs(spk_dir, exist_ok=True)
                write_wav(os.path.join(spk_dir, name + ".wav"), adv_i)
            name2success[name] = bool(ok)

    rate = None
    if name2success and rank0:
        rate = sum(name2success.values()) * 100 / len(name2success)
        print(args.defense, args.defense_param, args.attacker,
              attacker_param_tag(args), "success rate: %f" % rate)
    return {"adver_dir": adver_dir, "success": name2success,
            "success_rate": rate, "attack_s": attack_s}


if __name__ == "__main__":
    main(parse_args())
