"""Enrollment CLI (port of speakerguard_tpu/cli/enroll.py, reference
enroll.py): builds speaker models by averaging embeddings over enrollment
utterances, computes z-norm stats from non-target test scores, writes
per-speaker and combined model files.

Embeddings are saved as .npy (the torch.save of the reference), and the
model files hold the same lines as the JAX CLI's, so a model file written
by either package loads in the other's IvPlda / XvPlda(model_file=...).

    python -m speakerguard_tpu_torch.cli.enroll -model_dir DIR -root DATA \\
        [-device cpu] iv_plda -gmm ... | xv_plda -extractor ...
"""

import os

import numpy as np
import torch

from speakerguard_tpu_torch.cli.common import (add_defense_args,
                                               add_device_arg,
                                               add_eval_dither_arg,
                                               add_system_subparsers,
                                               build_model, eval_rng_stream)
from speakerguard_tpu_torch.utils.audio_io import read_wav
from speakerguard_tpu_torch.utils.kaldi_io import write_enroll_model_file


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("-model_dir", default="model_file")
    parser.add_argument("-root", default="data")
    add_defense_args(parser)
    add_eval_dither_arg(parser)
    add_device_arg(parser)
    add_system_subparsers(parser, with_model_file=False)
    return parser.parse_args(argv)


def _wav(path, device):
    """One utterance in the origin (int16) domain, (1, L) on ``device``."""
    wav = read_wav(path) * (2.0 ** 15)
    return torch.tensor(wav[None], dtype=torch.float32, device=device)


@torch.no_grad()
def main(args):
    base, model, defense_name = build_model(args, need_enroll=False)
    dev = model.device

    des_path = os.path.join(args.model_dir, args.system_type)
    os.makedirs(des_path, exist_ok=True)

    enroll_dir = os.path.join(args.root, "Spk10_enroll")
    test_dir = os.path.join(args.root, "Spk10_test")
    rngs = eval_rng_stream(args)
    call_idx = 0
    rows = []  # (spk_id, emb_path, z_mean, z_std) per speaker
    for spk_id in sorted(os.listdir(enroll_dir)):
        spk_dir = os.path.join(enroll_dir, spk_id)
        if not os.path.isdir(spk_dir):
            continue
        embs = []
        for audio_name in sorted(os.listdir(spk_dir)):
            emb = model.embedding(_wav(os.path.join(spk_dir, audio_name),
                                       dev), rng=rngs(call_idx))
            call_idx += 1
            embs.append(emb[0].cpu().numpy())
        emb = np.mean(np.stack(embs), axis=0, keepdims=True)  # (1, D)
        suffix = (args.system_type if defense_name is None
                  else f"{args.system_type}-{defense_name}")
        emb_path = os.path.join(des_path, f"{spk_id}.{suffix}.npy")
        np.save(emb_path, emb)
        enroll_emb = torch.tensor(emb, device=dev)

        # z-norm stats from other speakers' test utterances
        nontarget_scores = []
        for test_spk in sorted(os.listdir(test_dir)):
            if test_spk == spk_id:
                continue
            tdir = os.path.join(test_dir, test_spk)
            if not os.path.isdir(tdir):
                continue
            for name in sorted(os.listdir(tdir)):
                score = float(model.score(
                    _wav(os.path.join(tdir, name), dev),
                    enroll_embs=enroll_emb,
                    rng=rngs(call_idx)).flatten()[0])
                call_idx += 1
                nontarget_scores.append(score)
                print(spk_id, name, score)
        z_mean = float(np.mean(nontarget_scores))
        z_std = float(np.std(nontarget_scores))
        rows.append((spk_id, emb_path, z_mean, z_std))
        tag = (f"speaker_model_{args.system_type}_{spk_id}"
               if defense_name is None else
               f"speaker_model_{args.system_type}_{defense_name}_{spk_id}")
        write_enroll_model_file(os.path.join(des_path, tag), *zip(rows[-1]))

    tag = (f"speaker_model_{args.system_type}" if defense_name is None else
           f"speaker_model_{args.system_type}_{defense_name}")
    write_enroll_model_file(os.path.join(des_path, tag), *zip(*rows))
    print("wrote", os.path.join(des_path, tag))


if __name__ == "__main__":
    main(parse_args())
