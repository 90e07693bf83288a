"""ECAPA-TDNN: raw weights from the seed, and the program built on them.

The weights are drawn on the device from one ``torch.Generator`` in two
calls (one uniform, one normal) and cut into tensors named as in
SpeechBrain's ECAPA_TDNN state dict (``blocks.0.conv.conv.weight``,
``blocks.1.res2net_block.blocks.0.norm.norm.running_var``, ...): the
convolutions and the 1x1 SE, attention and FC layers as PyTorch
initialises them (uniform in +-1/sqrt(fan_in)), each batch norm's running
statistics and affine part, and the enrolled speakers' embeddings
(``enroll``).  The reference reads the same dict; the program gets its
tuples through its own constructors.
"""

import math

import torch

from benchmark.models import draw


def layout(cfg: dict) -> list:
    """(prefix, C_in, C_out, k) of every TDNN block in order: h0, each
    SE-Res2 block's tdnn1, its Res2 branches and tdnn2, MFA, the pooling's
    first layer."""
    c, scale = cfg["channels"], cfg["res2net_scale"]
    k0, mfa = cfg["kernel_sizes"][0], cfg["mfa_channels"]
    out = [("blocks.0", cfg["frontend"]["num_ceps"], c, k0)]
    for j in range(1, len(cfg["dilations"]) - 1):
        k = cfg["kernel_sizes"][j]
        out.append((f"blocks.{j}.tdnn1", c, c, 1))
        out += [(f"blocks.{j}.res2net_block.blocks.{i}", c // scale,
                 c // scale, k) for i in range(scale - 1)]
        out.append((f"blocks.{j}.tdnn2", c, c, 1))
    n_blocks = len(cfg["dilations"]) - 2
    out.append(("mfa", n_blocks * c, mfa, cfg["kernel_sizes"][-1]))
    out.append(("asp.tdnn", 3 * mfa, cfg["attention_channels"], 1))
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    c, se = cfg["channels"], cfg["se_channels"]
    mfa, att = cfg["mfa_channels"], cfg["attention_channels"]
    emb, spk = cfg["embedding_dim"], cfg["enrolled_speakers"]
    u = draw.Uniform()
    handles = {}

    def bn(prefix, n):
        handles[f"{prefix}.running_mean"] = u.add((n,), 0.0, 0.1)
        handles[f"{prefix}.running_var"] = u.add((n,), 0.5, 1.5)
        handles[f"{prefix}.weight"] = u.add((n,), 0.5, 1.5)
        handles[f"{prefix}.bias"] = u.add((n,), -0.1, 0.1)

    def conv(prefix, cin, cout, k):
        bound = 1.0 / math.sqrt(cin * k)
        handles[f"{prefix}.weight"] = u.add((cout, cin, k), -bound, bound)
        handles[f"{prefix}.bias"] = u.add((cout,), -bound, bound)

    for prefix, cin, cout, k in layout(cfg):
        conv(f"{prefix}.conv.conv", cin, cout, k)
        bn(f"{prefix}.norm.norm", cout)
    for j in range(1, len(cfg["dilations"]) - 1):
        conv(f"blocks.{j}.se_block.conv1.conv", c, se, 1)
        conv(f"blocks.{j}.se_block.conv2.conv", se, c, 1)
    conv("asp.conv.conv", att, mfa, 1)
    bn("asp_bn.norm", 2 * mfa)
    conv("fc.conv", 2 * mfa, emb, 1)
    n = draw.Normal()
    enroll = n.add((spk, emb), 1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u.fill(gen, device)
    n.fill(gen, device)
    w = {k: h() for k, h in handles.items()}
    w["enroll"] = enroll()
    return w


def build_program(w: dict, cfg: dict, program: dict, device):
    """The port's EcapaCos on these weights, with the mix's path."""
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.ecapa import (
        DILATIONS, BNAffine, EcapaCos, EcapaParams, SERes2Params, TBParams)

    if tuple(cfg["dilations"][1:-1]) != DILATIONS:
        raise ValueError(f"the program's SE-Res2 dilations are {DILATIONS}, "
                         f"the configuration's {cfg['dilations'][1:-1]}")

    def bn(prefix):
        return BNAffine(*(w[f"{prefix}.{k}"] for k in (
            "running_mean", "running_var", "weight", "bias")))

    def tb(prefix):
        return TBParams(w[f"{prefix}.conv.conv.weight"],
                        w[f"{prefix}.conv.conv.bias"],
                        bn(f"{prefix}.norm.norm"))

    def conv1x1(prefix):
        return w[f"{prefix}.weight"][:, :, 0], w[f"{prefix}.bias"]

    scale = cfg["res2net_scale"]
    blocks = []
    for j in range(1, len(cfg["dilations"]) - 1):
        res2 = tuple(tb(f"blocks.{j}.res2net_block.blocks.{i}")
                     for i in range(scale - 1))
        blocks.append(SERes2Params(
            tb(f"blocks.{j}.tdnn1"), res2, tb(f"blocks.{j}.tdnn2"),
            *conv1x1(f"blocks.{j}.se_block.conv1.conv"),
            *conv1x1(f"blocks.{j}.se_block.conv2.conv")))
    params = EcapaParams(tb("blocks.0"), tuple(blocks), tb("mfa"),
                         tb("asp.tdnn"), *conv1x1("asp.conv.conv"),
                         bn("asp_bn.norm"), *conv1x1("fc.conv"))
    model = EcapaCos(params, fast=FastPath(**program["fast_path"]))
    model.set_enrollment([str(i) for i in range(w["enroll"].shape[0])],
                         w["enroll"])
    return model
