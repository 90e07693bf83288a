"""Shared CLI plumbing: model/defense construction, nested subparsers.

Port of speakerguard_tpu/cli/common.py.  Preserves the reference's
positional CLI grammar (`<common args> <system_type> <model args> <attack>
<attack args>`, reference attackMain.py:32-152) over the port's models.

One argument the JAX CLIs lack: ``-device`` (default ``cuda``, as the
port's ``resolve_device`` and ``bench.py --device``).  Every model and
tensor of a CLI run lives there.  Nothing falls back to the CPU: without a
CUDA device a CLI raises unless it is given ``-device cpu``.
"""

import numpy as np
import torch

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.defenses.registry import parser_defense
from speakerguard_tpu_torch.models.defended import DefendedModel


def add_defense_args(parser):
    parser.add_argument("-defense", nargs="+", default=None)
    parser.add_argument("-defense_param", nargs="+", default=None)
    parser.add_argument("-defense_flag", nargs="+", default=None, type=int)
    parser.add_argument("-defense_order", default="sequential",
                        choices=["sequential", "average"])


def add_device_arg(parser):
    parser.add_argument("-device", default="cuda",
                        help="torch device of the run (cuda unless told "
                             "otherwise; cpu runs the plain versions)")


def add_eval_dither_arg(parser):
    """-eval_dither restores the reference's stochastic evaluation: the
    reference applies Kaldi-MFCC dither=1.0 unconditionally inside the
    frontend (reference model/iv_plda.py:212-215), so its EER/threshold
    statistics are computed on dithered features.  Our frontends apply
    dither only when an rng is threaded in, making evaluation deterministic
    by default; pass this flag for reference-parity experiments."""
    parser.add_argument("-eval_dither", action="store_true", default=False)
    parser.add_argument("-eval_dither_seed", type=int, default=0)


def cli_device(args) -> torch.device:
    """The run's device (``-device``); raises when it is a CUDA device and
    torch sees none, instead of running elsewhere."""
    dev = resolve_device(getattr(args, "device", None))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch; pass "
                           "-device cpu to run on the CPU")
    return dev


def seeded_generator(device, seed: int, index: int) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from the pair (seed, index)
    through numpy's SeedSequence: the port's counterpart of JAX's
    ``fold_in(PRNGKey(seed), index)``.  The two draw different numbers."""
    gen = torch.Generator(device=device)
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        1, np.uint64)[0]
    gen.manual_seed(int(state))
    return gen


def eval_rng_stream(args):
    """Returns `i -> (torch.Generator or None)` for eval CLI model calls:
    None (deterministic, the default) unless -eval_dither was passed, then
    a generator on the run's device seeded from (eval_dither_seed, i).  The
    JAX CLIs use ``fold_in(PRNGKey(eval_dither_seed), i)``, so the dither
    draws differ between the packages."""
    if not getattr(args, "eval_dither", False):
        return lambda i: None
    dev = cli_device(args)
    seed = getattr(args, "eval_dither_seed", 0)
    return lambda i: seeded_generator(dev, seed, i)


def add_system_subparsers(parser, with_model_file=True):
    sub = parser.add_subparsers(dest="system_type")
    iv = sub.add_parser("iv_plda")
    iv.add_argument("-gmm", default="pre-trained-models/iv_plda/final_ubm.txt")
    iv.add_argument("-extractor",
                    default="pre-trained-models/iv_plda/final_ie.txt")
    iv.add_argument("-plda", default="pre-trained-models/iv_plda/plda.txt")
    iv.add_argument("-mean", default="pre-trained-models/iv_plda/mean.vec")
    iv.add_argument("-transform",
                    default="pre-trained-models/iv_plda/transform.txt")
    if with_model_file:
        iv.add_argument("-model_file",
                        default="model_file/iv_plda/speaker_model_iv_plda")

    xv = sub.add_parser("xv_plda")
    xv.add_argument("-extractor",
                    default="pre-trained-models/xv_plda/xvecTDNN_origin.ckpt")
    xv.add_argument("-plda", default="pre-trained-models/xv_plda/plda.txt")
    xv.add_argument("-mean", default="pre-trained-models/xv_plda/mean.vec")
    xv.add_argument("-transform",
                    default="pre-trained-models/xv_plda/transform.txt")
    if with_model_file:
        xv.add_argument("-model_file",
                        default="model_file/xv_plda/speaker_model_xv_plda")

    an = sub.add_parser("audionet_csine")
    an.add_argument("-extractor", default=None)
    an.add_argument("-label_encoder",
                    default="./label-encoder-audionet-Spk251_test.txt")

    ec = sub.add_parser("ecapa")
    ec.add_argument("-extractor",
                    default="pre-trained-models/ecapa/embedding_model.ckpt",
                    help="a state dict of SpeechBrain's ECAPA_TDNN")
    if with_model_file:
        ec.add_argument("-model_file",
                        default="model_file/ecapa/speaker_model_ecapa")
    return iv, xv, an, ec


def build_model(args, need_enroll=True):
    """Construct the (defended) model from parsed CLI args on the run's
    device.  Returns (base model, defended model, defense name)."""
    dev = cli_device(args)
    threshold = getattr(args, "threshold", None)
    model_file = getattr(args, "model_file", None) if need_enroll else None
    if args.system_type == "iv_plda":
        from speakerguard_tpu_torch.models.iv_plda import (
            IvPlda, load_iv_plda_params)
        from speakerguard_tpu_torch.ops.kaldi_mfcc import MfccConfig
        params = load_iv_plda_params(args.gmm, args.extractor, args.plda,
                                     args.mean, args.transform, device=dev)
        # infer num_ceps from the UBM dim (features are ceps*3 post-delta)
        num_ceps = params.fgmm.dim // 3
        assert num_ceps * 3 == params.fgmm.dim, \
            f"UBM dim {params.fgmm.dim} is not divisible by 3"
        base = IvPlda(params, model_file=model_file, threshold=threshold,
                      mfcc_config=MfccConfig(num_ceps=num_ceps))
    elif args.system_type == "xv_plda":
        from speakerguard_tpu_torch.models.xv_plda import (
            XvPlda, load_xv_plda_params)
        params = load_xv_plda_params(args.extractor, args.plda, args.mean,
                                     args.transform, device=dev)
        base = XvPlda(params, model_file=model_file, threshold=threshold)
    elif args.system_type == "audionet_csine":
        from speakerguard_tpu_torch.models.audionet import (
            AudioNet, load_audionet_from_torch_state, parse_label_encoder)
        from speakerguard_tpu_torch.models.training import load_checkpoint
        spk_ids = (parse_label_encoder(args.label_encoder)
                   if args.label_encoder else None)
        assert args.extractor is not None, "audionet needs a checkpoint"
        try:
            params, state, _, _ = load_checkpoint(args.extractor, device=dev)
        except Exception:
            # reference checkpoints are torch state dicts
            params, state = load_audionet_from_torch_state(
                torch.load(args.extractor, map_location="cpu"), device=dev)
        base = AudioNet(params, state, spk_ids=spk_ids)
    elif args.system_type == "ecapa":
        from speakerguard_tpu_torch.models.ecapa import (
            EcapaCos, load_ecapa_from_torch_state)
        base = EcapaCos(load_ecapa_from_torch_state(args.extractor,
                                                    device=dev),
                        model_file=model_file, threshold=threshold)
    else:
        raise NotImplementedError("Unsupported system type")

    defense, defense_name = parser_defense(
        args.defense, args.defense_param, args.defense_flag,
        args.defense_order)
    model = DefendedModel(base, defense=defense, order=args.defense_order)
    return base, model, defense_name
