"""Operations and bytes of ECAPA-TDNN at a cell's shapes, counted from the
mathematics once ("same" convolutions: T_out = T):

    front end                ``frontend.py``
    each TDNN block          2 B T C_in k C_out: h0, each SE-Res2 block's
                             two 1x1 layers and its scale - 1 Res2
                             branches, MFA, the pooling's first layer
    squeeze-excitation       2 B (C se + se C) a block
    attention logits         2 B T att MFA (the 1x1 after the tanh)
    FC and cosine            2 B 2 MFA emb, 2 B S emb

The BNs, ReLUs, means, softmax and weighted statistics are elementwise and
not counted.  An attack's input gradient computes each product's
transpose once, the same count again; no weight gradient is taken.

``blocks`` gives each TDNN block's own work as one launch of the block
kernel computes it, a direction: the operations above, and the bf16 input
(B T C_in), weights (C_out C_in k) and output (B T C_out) each read or
written once; the padding, the mask, the bias and the BN are left out, so
the bound is never above the truth.

``pool_fwd`` and ``pool_bwd`` give the attentive statistics' kernel
(``asp_stats``) its work a launch, over the MFA's C channels: forward the
float32 logits and bf16 activations (B T C) read once and five (B, C)
float32 vectors written; backward the same inputs, the statistics and
cotangents read, the float32 and bf16 cotangents (B T C) written.  Their
operations (softmax 3, mean 2, centred variance 4 an element forward; 12
backward) are counted but never bind.
"""

from benchmark.flops import frontend
from benchmark.models.ecapa_tdnn import layout


def blocks(cfg: dict, batch: int, frames: int) -> list:
    """[(operations, bytes)] of each TDNN block's launch, in order."""
    return [(2.0 * batch * frames * cin * k * cout,
             2.0 * (batch * frames * cin + cout * cin * k
                    + batch * frames * cout))
            for _, cin, cout, k in layout(cfg)]


def forward(cfg: dict, batch: int, samples: int) -> float:
    t, _, _ = frontend.frames(cfg, samples)
    ops = frontend.forward(cfg, batch, samples)
    ops += sum(o for o, _ in blocks(cfg, batch, t))
    c, se, mfa = cfg["channels"], cfg["se_channels"], cfg["mfa_channels"]
    emb = cfg["embedding_dim"]
    ops += (len(cfg["dilations"]) - 2) * 2.0 * batch * 2 * c * se
    ops += 2.0 * batch * t * cfg["attention_channels"] * mfa
    ops += 2.0 * batch * (2 * mfa * emb + cfg["enrolled_speakers"] * emb)
    return ops


def attack(cfg: dict, traffic: dict) -> float:
    """One whole PGD call: each iteration a forward and an input gradient,
    then the final evaluation."""
    b, n = traffic["batch"], traffic["samples"]
    f = forward(cfg, b, n)
    return traffic["attack"]["max_iter"] * 2.0 * f + f


def parameters(cfg: dict) -> int:
    """Trainable weights: the blocks' convolutions, biases and BN affine
    parts, the SE and attention layers, the pooled BN's affine part and the
    FC (running statistics not counted)."""
    n = sum(cin * k * cout + 3 * cout for _, cin, cout, k in layout(cfg))
    c, se, mfa = cfg["channels"], cfg["se_channels"], cfg["mfa_channels"]
    att, emb = cfg["attention_channels"], cfg["embedding_dim"]
    n += (len(cfg["dilations"]) - 2) * (c * se + se + se * c + c)
    n += att * mfa + mfa + 2 * 2 * mfa + 2 * mfa * emb + emb
    return n


def pool_fwd(cfg: dict, batch: int, frames: int) -> tuple:
    n, bc = batch * frames * cfg["mfa_channels"], batch * cfg["mfa_channels"]
    return 9.0 * n, float(4 * n + 2 * n + 5 * 4 * bc)


def pool_bwd(cfg: dict, batch: int, frames: int) -> tuple:
    n, bc = batch * frames * cfg["mfa_channels"], batch * cfg["mfa_channels"]
    return 12.0 * n, float((4 + 2) * n + 7 * 4 * bc + (4 + 2) * n)
