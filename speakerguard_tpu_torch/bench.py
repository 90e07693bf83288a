"""PGD-100, CW2, FAKEBOB, SirenAttack or Kenan ssa on the port, or AudioNet
training: the JAX package's bench.py for xv-PLDA (its default), iv-PLDA
(its BENCH_MODEL=iv_plda) and AudioNet (BENCH_MODEL=audionet), with PGD,
(BENCH_ATTACK=cw2) CW2, (BENCH_ATTACK=fakebob) FAKEBOB, (BENCH_ATTACK=siren)
SirenAttack or (BENCH_ATTACK=kenan_ssa) Kenan ssa; or its
BENCH_ATTACK=natural_train / adver_train with BENCH_TRAIN_PRECISION.

    python -m speakerguard_tpu_torch.bench [--model {xv_plda,iv_plda,audionet}]
        [--attack {pgd,cw2,fakebob,siren,kenan_ssa}] [--batch 512]
        [--iters 100] [--cw2-iters 200] [--cw2-bss 3] [--fb-iters 100]
        [--fb-samples 50] [--siren-epochs 10] [--siren-iters 30]
        [--siren-particles 25] [--kenan-iters 15]
        [--defense QT,FeCo] [--defense-param '512|kmeans 0.2 L2']
        [--defense-flag 0,1] [--eot 2]
        [--wav-len 48000] [--warmup 1] [--reps 3] [--device cuda]
    python -m speakerguard_tpu_torch.bench --train {natural,adver}
        [--precision {f32,bf16}] [--batch 128] [--wav-len 80000]
        [--warmup 2] [--reps 5] [--device cuda]

The weights and inputs are drawn from numpy seed 0 in bench.py's order:
xv-PLDA at full width with 10 enrolled speakers (CSI-E), iv-PLDA at full
width (C=2048, IV=600, R=200) with 10 enrolled speakers, or AudioNet
(``init_audionet(rng, 10)``, CSI-NE), then the waves and random labels.
PGD runs ``--iters`` iterations with eps 0.002, step 0.0004 and the Entropy
loss on the model's default fast path (``FastPath()`` on the card, off on
the CPU).  CW2 runs ``--cw2-bss`` binary-search steps of ``--cw2-iters``
Adam steps (task CSI, early stop off, initial const 10) on the exact path;
its metric counts cw2-iters x cw2-bss iterations, as bench.py's does.
FAKEBOB runs ``--fb-iters`` NES iterations of ``--fb-samples`` antithetic
samples each (task CSI, eps 0.002, max lr 0.001, early stop off, all the
samples in one model batch, ``fast=True``); its metric counts fb-iters
iterations, and ``executed_iters`` says how many NES bodies the last timed
attack ran (fewer when every lane is found early), with
``ms_per_executed_iter`` the mean time of one.
SirenAttack runs ``--siren-epochs`` epochs of ``--siren-iters`` PSO
iterations over ``--siren-particles`` particles (task CSI, eps 0.002, abort
off, ``fast=True``); its metric counts epochs x iterations, as bench.py's
does, and ``executed_epochs`` says how many epochs ran (fewer when every
lane is found).  Its batch defaults to bench.py's 32 on xv-PLDA and 16 on
the others.  Kenan ssa runs ``--kenan-iters`` binary-search steps (early
stop off) on 8,000-sample waves by default (bench.py's BENCH_WAV_LEN=8000
for this attack: the SVD grows with the window squared) at batch 16;
``executed_steps`` says how many steps ran.
``--defense`` (bench.py's BENCH_DEFENSE, comma-separated names) wraps the
model in a sequential ``DefendedModel``: ``--defense-param`` gives each
defense's parameters ('|'-separated; default: FeCo and FEATURE_COMPRESSION
"kmeans 0.2 L2", the others their registry defaults), ``--defense-flag``
its flag level (','-separated; default 1 for FeCo, 0 for the others).  PGD
takes ``--eot`` EOT repeats (BENCH_EOT).  The metric then carries
"_<names joined by '-'>" and, above one repeat, "_eot<N>":
``pgd100_xv_plda_FeCo_eot2_utts_per_sec``.
After ``--warmup`` attacks, ``--reps`` attacks are timed on the host clock,
each ending in a device synchronise.  Prints one JSON line in bench.py's
shape: metric, value (utterances/s), unit, attack_success_rate_pct, batch,
plus the device it ran on and the mean ms per counted iteration.

``--train`` times AudioNet training as bench.py's bench_train does: 251
classes (``init_audionet(rng, 251)``), Adam 1e-3, then the waves (uniform
in +-0.3, batch 128 of 80,000 samples) and the labels (``integers(0,
251)``), drawn in that order from numpy seed 0.  ``natural``: one step with
noise augmentation (aug_eps 0.002, so 256 waves a step); ``adver``: PGD-10
(eps 0.002, step 0.0004) against the live model on half the batch, no
augmentation.  ``--precision bf16`` is the mixed-precision step.  After
``--warmup`` steps (kept, as JAX keeps its compile step's; two, since
cuDNN's autotuning takes the first step's shapes and then the second's
parameters, views into Adam's flat buffer at new alignments), ``--reps``
steps on the one batch are timed on the host clock, ending in a device
synchronise.  One JSON line with JAX's metric name
(``natural_train_audionet[_bf16]_utts_per_sec``,
``adver_train_pgd10_audionet[_bf16]_utts_per_sec``; utterances/s =
batch / step time), ``final_loss``, ``batch``, the ms per step, the peak
device memory and the device.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.attacks import (CW2, FAKEBOB, PGD, Kenan,
                                            SirenAttack)
from speakerguard_tpu_torch.defenses.registry import parser_defense
from speakerguard_tpu_torch.models.audionet import AudioNet, init_audionet
from speakerguard_tpu_torch.models.defended import DefendedModel
from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                   random_iv_plda_params)
from speakerguard_tpu_torch.models.training import (make_adver_train_step,
                                                    make_natural_train_step,
                                                    make_pgd_for_training)
from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                   random_xv_plda_params)
from speakerguard_tpu_torch.optim import Adam


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=("xv_plda", "iv_plda", "audionet"),
                   default="xv_plda")
    p.add_argument("--attack", choices=("pgd", "cw2", "fakebob", "siren",
                                        "kenan_ssa"), default="pgd")
    p.add_argument("--batch", type=int, default=None,
                   help="default 512; siren 32 on xv-PLDA, 16 otherwise; "
                        "kenan_ssa 16")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--cw2-iters", type=int, default=200)
    p.add_argument("--cw2-bss", type=int, default=3)
    p.add_argument("--fb-iters", type=int, default=100)
    p.add_argument("--fb-samples", type=int, default=50)
    p.add_argument("--siren-epochs", type=int, default=10)
    p.add_argument("--siren-iters", type=int, default=30)
    p.add_argument("--siren-particles", type=int, default=25)
    p.add_argument("--kenan-iters", type=int, default=15)
    p.add_argument("--defense", default=None,
                   help="comma-separated defenses, e.g. QT,FeCo")
    p.add_argument("--defense-param", default=None,
                   help="'|'-separated parameters, one per defense")
    p.add_argument("--defense-flag", default=None,
                   help="','-separated flag levels, one per defense")
    p.add_argument("--eot", type=int, default=1)
    p.add_argument("--wav-len", type=int, default=None,
                   help="default 48000; kenan_ssa 8000")
    p.add_argument("--train", choices=("natural", "adver"), default=None,
                   help="time AudioNet training instead of an attack")
    p.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    p.add_argument("--warmup", type=int, default=None,
                   help="default 1; 2 with --train")
    p.add_argument("--reps", type=int, default=None,
                   help="default 3; 5 with --train")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.warmup is None:
        args.warmup = 2 if args.train else 1
    if args.reps is None:
        args.reps = 5 if args.train else 3
    if args.train:
        args.batch = args.batch or 128
        args.wav_len = args.wav_len or 80000
        return args
    if args.batch is None:
        args.batch = {"siren": 32 if args.model == "xv_plda" else 16,
                      "kenan_ssa": 16}.get(args.attack, 512)
    if args.wav_len is None:
        args.wav_len = 8000 if args.attack == "kenan_ssa" else 48000
    return args


FEATURE_LEVEL = ("FeCo", "FEATURE_COMPRESSION")


def defend(model, args):
    """(model wrapped in the ``--defense`` defenses, the metric's tag)."""
    tag = ""
    if args.defense:
        names = args.defense.split(",")
        params = (args.defense_param.split("|") if args.defense_param else
                  ["kmeans 0.2 L2" if n in FEATURE_LEVEL else None
                   for n in names])
        flags = ([int(f) for f in args.defense_flag.split(",")]
                 if args.defense_flag else
                 [1 if n in FEATURE_LEVEL else 0 for n in names])
        defense, _ = parser_defense(names, params, flags, "sequential")
        model = DefendedModel(model, defense=defense, order="sequential")
        tag = "_" + "-".join(names)
    if args.eot > 1:
        tag += f"_eot{args.eot}"
    return model, tag


def run(args) -> dict:
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    if args.model == "audionet":
        model = AudioNet(*init_audionet(rng, 10, device=dev))
    elif args.model == "iv_plda":
        model = IvPlda(random_iv_plda_params(rng, device=dev))
        model.set_enrollment([str(i) for i in range(10)],
                             rng.standard_normal((10, 200)).astype(
                                 np.float32))
    else:
        model = XvPlda(random_xv_plda_params(rng, device=dev))
        model.set_enrollment([str(i) for i in range(10)],
                             rng.standard_normal((10, 150)).astype(
                                 np.float32))
    model, tag = defend(model, args)
    x = torch.tensor(rng.uniform(-0.3, 0.3, (args.batch, args.wav_len))
                     .astype(np.float32), device=dev)
    y = torch.tensor(rng.integers(0, 10, args.batch), device=dev)
    if args.attack == "cw2":
        # early stop off, so that the iteration count is deterministic
        iters = args.cw2_iters * args.cw2_bss
        atk = CW2(model, task="CSI", max_iter=args.cw2_iters,
                  binary_search_steps=args.cw2_bss, stop_early=False,
                  initial_const=10.0)
    elif args.attack == "fakebob":
        iters = args.fb_iters
        atk = FAKEBOB(model, task="CSI", epsilon=0.002, max_iter=iters,
                      samples_per_draw=args.fb_samples,
                      samples_per_draw_batch_size=args.fb_samples,
                      max_lr=0.001, stop_early=False)
    elif args.attack == "siren":
        iters = args.siren_epochs * args.siren_iters
        atk = SirenAttack(model, task="CSI", epsilon=0.002,
                          max_epoch=args.siren_epochs,
                          max_iter=args.siren_iters,
                          n_particles=args.siren_particles,
                          abort_early=False)
    elif args.attack == "kenan_ssa":
        iters = args.kenan_iters
        atk = Kenan(model, atk_name="ssa", max_iter=iters)
    else:
        iters = args.iters
        atk = PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
                  max_iter=iters, loss="Entropy", EOT_size=args.eot)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for w in range(args.warmup):
        atk.attack(x, y, rng=1000 + w)
    sync()
    t0 = time.perf_counter()
    for i in range(args.reps):
        _, success = atk.attack(x, y, rng=i)
    sync()
    dt = (time.perf_counter() - t0) / args.reps
    rec = {
        "metric": f"{args.attack}{iters}_{args.model}{tag}_utts_per_sec",
        "value": args.batch / dt,
        "unit": "utterances/sec",
        "attack_success_rate_pct": 100.0 * sum(success) / len(success),
        "batch": args.batch,
        "wav_len": args.wav_len,
        "ms_per_iter": dt * 1e3 / iters,
        "defense": args.defense, "eot": args.eot,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "fast_path": (None if model.fast_path is None
                      else vars(model.fast_path)),
    }
    if args.attack == "fakebob":
        rec["executed_iters"] = atk.last_executed_iters
        rec["ms_per_executed_iter"] = dt * 1e3 / atk.last_executed_iters
    elif args.attack == "siren":
        rec["executed_epochs"] = atk.last_executed_epochs
        rec["particle_evals"] = atk.last_particle_evals
        rec["guard_evals"] = atk.last_guard_evals
    elif args.attack == "kenan_ssa":
        rec["executed_steps"] = atk.last_executed_steps
    return rec


def run_train(args) -> dict:
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    num_class = 251
    params, state = init_audionet(rng, num_class, device=dev)
    opt = Adam(1e-3)
    opt_state = opt.init(params)
    tag = "" if args.precision == "f32" else f"_{args.precision}"
    if args.train == "adver":
        step = make_adver_train_step(
            opt, make_pgd_for_training(epsilon=0.002, step_size=0.0004,
                                       max_iter=10),
            ratio=0.5, aug_eps=0.0, compute_dtype=args.precision)
        metric = f"adver_train_pgd10_audionet{tag}_utts_per_sec"
    else:
        step = make_natural_train_step(opt, aug_eps=0.002,
                                       compute_dtype=args.precision)
        metric = f"natural_train_audionet{tag}_utts_per_sec"
    wavs = torch.tensor(rng.uniform(-0.3, 0.3, (args.batch, args.wav_len))
                        .astype(np.float32), device=dev)
    labels = torch.tensor(rng.integers(0, num_class, args.batch),
                          device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda = dev.type == "cuda"
    for _ in range(args.warmup):
        out = step(params, state, opt_state, wavs, labels, rng=gen)
        params, state, opt_state = out[:3]
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = step(params, state, opt_state, wavs, labels, rng=gen)
        params, state, opt_state = out[:3]
    if cuda:
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / args.reps
    return {
        "metric": metric, "value": args.batch / dt,
        "unit": "utterances/sec", "final_loss": float(out[3]),
        "batch": args.batch, "wav_len": args.wav_len,
        "precision": args.precision, "ms_per_step": dt * 1e3,
        "reps": args.reps,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if cuda else None),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    print(json.dumps(run_train(args) if args.train else run(args)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
