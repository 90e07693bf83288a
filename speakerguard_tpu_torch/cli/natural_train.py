"""Natural training CLI for AudioNet CSI-NE.

Port of speakerguard_tpu/cli/natural_train.py (reference natural_train.py):
Adam + cross entropy + uniform-noise augmentation, a checkpoint every epoch
and the final one, validation every ``-evaluate_per_epoch`` epochs, per-batch
and per-epoch lines in the JAX CLI's format and its file logger.  The step
is ``models/training.py``'s.

Where it differs from the JAX CLI:
  * ``-device`` (default cuda) holds the model and every batch
    (cli/common.py); without a CUDA device it raises unless given
    ``-device cpu``.
  * The step's augmentation draws come from a torch.Generator on the device
    seeded with ``-seed``, where JAX splits ``PRNGKey(seed)`` per batch:
    the draws differ.  ``main(args, draws=)`` takes another source:
    ``draws(step)`` gives the ``draw_fn(kind, shape)`` of the run's
    ``step``-th batch (the CPU tests pass JAX's).
  * ``-n_devices N`` > 1 runs N ranks (``parallel.mesh.launch``: spawned
    from a plain process, or one each under ``torchrun``), joined with
    nccl on cuda and gloo on the CPU.  Each rank
    loads its rows of every global batch of ``-batch_size``
    (``parallel.input.host_sharded_batches``, the ragged tail dropped)
    and runs the sharded step, which computes the global batch's step;
    rank 0 prints, logs, validates and writes the pickles.
  * ``-ckpt_backend dcp`` writes each checkpoint as a
    torch.distributed.checkpoint directory, asynchronously (every rank
    writes its part); ``orbax`` raises: orbax imports JAX, and the pickle
    (the default) is the format both packages read.
"""

import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from speakerguard_tpu_torch.cli.common import (add_defense_args,
                                               add_device_arg, cli_device)
from speakerguard_tpu_torch.data.dataset import Spk251_test, Spk251_train
from speakerguard_tpu_torch.models.audionet import (AudioNet,
                                                    init_audionet,
                                                    parse_label_encoder)
from speakerguard_tpu_torch.models.training import (DcpCheckpointer,
                                                    load_checkpoint,
                                                    make_natural_train_step,
                                                    save_checkpoint)
from speakerguard_tpu_torch.optim import Adam
from speakerguard_tpu_torch.parallel.input import (host_sharded_batches,
                                                   make_global_batch,
                                                   prefetch)
from speakerguard_tpu_torch.parallel.mesh import (is_rank0, launch,
                                                  make_mesh, rank_device,
                                                  replicate,
                                                  sharded_train_step)


def add_train_args(parser, ckpt_base):
    """The arguments both training CLIs take."""
    add_defense_args(parser)
    parser.add_argument("-label_encoder",
                        default="./label-encoder-audionet-Spk251_test.txt")
    parser.add_argument("-aug_eps", type=float, default=0.002)
    parser.add_argument("-root", default="./data")
    parser.add_argument("-num_epoches", type=int, default=30)
    parser.add_argument("-batch_size", type=int, default=128)
    parser.add_argument("-wav_length", type=int, default=80_000)
    parser.add_argument("-model_ckpt", type=str, default=None,
                        help=f"checkpoint base (default {ckpt_base})")
    parser.add_argument("-log", type=str, default=None)
    parser.add_argument("-ori_model_ckpt", type=str, default=None)
    parser.add_argument("-start_epoch", type=int, default=0)
    parser.add_argument("-evaluate_per_epoch", type=int, default=1)
    parser.add_argument("-lr", type=float, default=1e-3)
    parser.add_argument("-n_devices", type=int, default=1)
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-precision", choices=("f32", "bf16"),
                        default="f32",
                        help="bf16 = mixed-precision train step (bf16 "
                             "network compute, f32 master weights, "
                             "optimizer and BN stats)")
    parser.add_argument("-ckpt_backend", choices=("pickle", "dcp", "orbax"),
                        default="pickle",
                        help="pickle (both packages read it) or dcp "
                             "(torch.distributed.checkpoint directories, "
                             "saved asynchronously); orbax is JAX's")
    add_device_arg(parser)


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    add_train_args(parser, "./model_file/audionet-natural")
    return parser.parse_args(argv)


def validate(params, state, spk_ids, root):
    """Accuracy of the model on Spk251_test, one whole wave at a time."""
    model = AudioNet(params, state, spk_ids=spk_ids)
    val = Spk251_test(spk_ids, root, return_file_name=True)
    right = 0
    for wavs, labels, _ in val.batches(1):
        d, _ = model.make_decision(torch.tensor(wavs[:, 0, :],
                                                device=model.device))
        right += int(int(d[0]) == labels[0])
    return right / len(val)


class CheckpointIO:
    """The ``-ckpt_backend``'s save and load.  Pickles are written by rank
    0 only; a dcp directory by every rank."""

    def __init__(self, backend):
        if backend == "orbax":
            raise ValueError(
                "-ckpt_backend orbax: orbax imports JAX; use dcp "
                "(torch.distributed.checkpoint directories, saved "
                "asynchronously) or pickle, the format both packages read")
        self.dcp = DcpCheckpointer() if backend == "dcp" else None

    def load(self, path, rng, num_class, lr, device):
        """(params, state, opt_state) of ``path``; a dcp template comes
        from ``rng``, as JAX's orbax template does."""
        if self.dcp is None:
            params, state, opt_state, _ = load_checkpoint(path, device)
            return params, state, opt_state
        p0, s0 = init_audionet(rng, num_class, device=device)
        params, state, opt_state, _ = self.dcp.load(
            path, p0, s0, Adam(lr).init(p0))
        return params, state, opt_state

    def save(self, path, params, state, opt_state, epoch, wait=False):
        if self.dcp is not None:
            self.dcp.save(path, params, state, opt_state, epoch, wait=wait)
        elif is_rank0():
            save_checkpoint(path, params, state, opt_state, epoch)


def file_logger(name, path):
    """The CLIs' file logger (reference natural_train.py:116-118); a second
    call replaces the first's handler."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):  # re-invocation must not duplicate lines
        logger.removeHandler(h)
        h.close()
    if is_rank0():
        logger.addHandler(logging.FileHandler(path))
    return logger


def setup(args, rng, num_class, device):
    """(params, state, opt_state, ckpt_io, mesh, wrap): the run's start,
    from ``-ori_model_ckpt`` or from ``rng``, replicated over the mesh of
    ``-n_devices`` (None for one); ``wrap(step)`` shards a step."""
    ckpt = CheckpointIO(args.ckpt_backend)
    if args.ori_model_ckpt:
        params, state, opt_state = ckpt.load(args.ori_model_ckpt, rng,
                                             num_class, args.lr, device)
    else:
        params, state = init_audionet(rng, num_class, device=device)
        opt_state = None
    if opt_state is None:
        opt_state = Adam(args.lr).init(params)
    mesh = None
    if args.n_devices > 1:
        mesh = make_mesh(args.n_devices, axes=("data",),
                         device_type=device.type)
        params, state, opt_state = replicate((params, state, opt_state),
                                             mesh)

    def wrap(step):
        return step if mesh is None else sharded_train_step(step, mesh)
    return params, state, opt_state, ckpt, mesh, wrap


def train_batches(train, args, mesh, device):
    """This rank's (wavs (b, L) scale domain, labels (b,)) of every global
    batch of an epoch, on ``device`` (the rank's, indexed): ``prefetch``'s
    thread loads them ahead on the host, and the caller's thread copies
    them to the device."""
    for wavs, labels in prefetch(host_sharded_batches(
            train, args.batch_size, mesh, shuffle=True,
            drop_last=args.n_devices > 1)):
        wavs = make_global_batch(wavs[:, 0, :], device)
        if train.domain == "origin":
            wavs = wavs / (2.0 ** 15)
        yield wavs, make_global_batch(labels, device)


def step_generator(args, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return gen


def run(args, draws=None):
    """One rank's run (the whole run without -n_devices).  Returns the
    per-batch losses, accuracies, labels (this rank's rows) and wall
    seconds (the step and the read of its loss), the per-epoch mean
    accuracies and the validation accuracies."""
    device = rank_device(cli_device(args))
    rng = np.random.default_rng(args.seed)
    if is_rank0():
        write_label_encoder_if_absent(args)
    if dist.is_initialized():
        dist.barrier()   # the other ranks read the encoder rank 0 wrote
    spk_ids = parse_label_encoder(args.label_encoder)
    params, state, opt_state, ckpt, mesh, wrap = setup(args, rng,
                                                       len(spk_ids), device)
    step = wrap(make_natural_train_step(Adam(args.lr), aug_eps=args.aug_eps,
                                        compute_dtype=args.precision))
    train = Spk251_train(spk_ids, args.root, wav_length=args.wav_length,
                         seed=args.seed)
    rank0 = is_rank0()
    if rank0:
        print("load train data done", len(train))

    ckpt_base = args.model_ckpt or "./model_file/audionet-natural"
    logger = file_logger("speakerguard_tpu_torch.natural_train",
                         args.log or f"{ckpt_base}.log")
    gen = step_generator(args, device)
    out = {"losses": [], "accs": [], "labels": [], "step_s": [],
           "epoch_accs": [], "val_accs": []}
    n_steps = 0
    for i_epoch in range(args.num_epoches):
        accs = []
        for batch_id, (wavs, labels) in enumerate(
                train_batches(train, args, mesh, device)):
            t0 = time.time()
            params, state, opt_state, loss, acc = step(
                params, state, opt_state, wavs, labels, rng=gen,
                draw_fn=draws(n_steps) if draws else None)
            n_steps += 1
            accs.append(float(acc))
            out["losses"].append(float(loss))
            out["step_s"].append(time.time() - t0)
            out["labels"].append(labels.tolist())
            if rank0:
                print(f"Batch {batch_id}: loss={float(loss):.4f} "
                      f"acc={float(acc):.4f} time={out['step_s'][-1]:.3f}s",
                      end="\r")
        out["accs"] += accs
        epoch = i_epoch + args.start_epoch
        out["epoch_accs"].append(float(np.mean(accs)))
        if rank0:
            print(f"\nEPOCH {epoch}: Acc = {np.mean(accs):.4f}")
        logger.info("EPOCH %d/%d: Acc = %.6f", epoch,
                    args.num_epoches + args.start_epoch, np.mean(accs))
        ckpt.save(f"{ckpt_base}_{epoch}", params, state, opt_state, epoch)
        if rank0 and args.evaluate_per_epoch > 0 and \
                i_epoch % args.evaluate_per_epoch == 0:
            val_acc = validate(params, state, spk_ids, args.root)
            out["val_accs"].append(val_acc)
            print("Val Acc: %f" % val_acc)
            logger.info("Val Acc: %.6f", val_acc)
    ckpt.save(ckpt_base, params, state, opt_state,
              args.num_epoches + args.start_epoch, wait=True)
    return out


def write_label_encoder_if_absent(args):
    """The reference ships the label encoder; it is built from the training
    set's speaker directories when absent."""
    if os.path.exists(args.label_encoder):
        return
    from speakerguard_tpu_torch.utils.kaldi_io import write_label_encoder
    train_root = os.path.join(args.root, "Spk251_train")
    spk_dirs = sorted(d for d in os.listdir(train_root)
                      if os.path.isdir(os.path.join(train_root, d)))
    write_label_encoder(args.label_encoder, spk_dirs)
    print(f"wrote label encoder for {len(spk_dirs)} speakers to "
          f"{args.label_encoder}")


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
