"""xv-PLDA: raw weights from the seed, and the program built on them.

The weights are drawn on the device from one ``torch.Generator`` in two
calls (one uniform, one normal) and cut into tensors: the TDNN's
convolutions and first affine layer as PyTorch initialises them
(uniform in +-1/sqrt(fan_in)), batch-norm running statistics, the LDA,
the PLDA (an orthogonal transform from a QR and positive
between-class variances) and the enrolled speakers' embeddings in the
PLDA space.  The reference reads the same dict; the program gets its
tuples through its own constructors.
"""

import math

import torch

from benchmark.models import draw


def make_weights(cfg: dict, seed: int, device) -> dict:
    tdnn = cfg["tdnn"]
    c_in = cfg["frontend"]["num_ceps"]
    emb, lda = cfg["embedding_dim"], cfg["lda_dim"]
    spk = cfg["enrolled_speakers"]
    u = draw.Uniform()
    conv_w, conv_b, bn_mean, bn_var = [], [], [], []
    for k, _, c_out in tdnn:
        bound = 1.0 / math.sqrt(c_in * k)
        conv_w.append(u.add((c_out, c_in, k), -bound, bound))
        conv_b.append(u.add((c_out,), -bound, bound))
        bn_mean.append(u.add((c_out,), 0.0, 0.1))
        bn_var.append(u.add((c_out,), 0.5, 1.5))
        c_in = c_out
    bound = 1.0 / math.sqrt(2 * c_in)
    fc1_w = u.add((emb, 2 * c_in), -bound, bound)
    fc1_b = u.add((emb,), -bound, bound)
    n = draw.Normal()
    emb_mean = n.add((emb,), 0.1)
    transform_mat = n.add((lda, emb + 1), 0.05)
    plda_mean = n.add((lda,), 0.1)
    plda_q = n.add((lda, lda), 1.0)
    plda_psi = n.add((lda,), 1.0)
    enroll = n.add((spk, lda), 1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u.fill(gen, device)
    n.fill(gen, device)
    w = {"conv_w": [t() for t in conv_w], "conv_b": [t() for t in conv_b],
         "bn_mean": [t() for t in bn_mean], "bn_var": [t() for t in bn_var],
         "fc1_w": fc1_w(), "fc1_b": fc1_b(), "emb_mean": emb_mean(),
         "transform_mat": transform_mat(), "plda_mean": plda_mean(),
         "plda_transform": torch.linalg.qr(plda_q())[0].contiguous(),
         "plda_psi": plda_psi().abs() + 0.5, "enroll": enroll()}
    return w


def build_program(w: dict, cfg: dict, program: dict, device):
    """The port's XvPlda on these weights, with the mix's path."""
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.plda import PLDAParams
    from speakerguard_tpu_torch.models.tdnn import BNStats, TDNNParams
    from speakerguard_tpu_torch.models.xv_plda import XvPlda, XvPldaParams

    emb = cfg["embedding_dim"]

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def bn(c):
        return BNStats(zeros(c), torch.ones(c, device=device))

    # the classifier head (fc2, fc3) is not on the embedding's path
    tdnn = TDNNParams(
        conv_w=tuple(w["conv_w"]), conv_b=tuple(w["conv_b"]),
        bn_tdnn=tuple(BNStats(m, v) for m, v in zip(w["bn_mean"],
                                                     w["bn_var"])),
        fc1_w=w["fc1_w"], fc1_b=w["fc1_b"], bn_fc1=bn(emb),
        fc2_w=zeros(emb, emb), fc2_b=zeros(emb), bn_fc2=bn(emb),
        fc3_w=zeros(cfg["num_classes"], emb), fc3_b=zeros(cfg["num_classes"]))
    params = XvPldaParams(
        tdnn=tdnn, plda=PLDAParams(w["plda_mean"], w["plda_transform"],
                                   w["plda_psi"]),
        emb_mean=w["emb_mean"], transform_mat=w["transform_mat"])
    model = XvPlda(params, fast=FastPath(**program["fast_path"]))
    model.set_enrollment([str(i) for i in range(w["enroll"].shape[0])],
                         w["enroll"])
    return model
