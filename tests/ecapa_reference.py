"""Plain float32 reference of ECAPA-TDNN with a cosine backend, for the CPU
tests of the port's models/ecapa.py.

Written from the layer equations of Desplanques, Thienpondt and Demuynck
(Interspeech 2020, arXiv:2005.07143) in the layer order of SpeechBrain's
ECAPA_TDNN, in plain torch on (B, C, T) tensors: each TDNN block a
``F.conv1d`` of its input padded with ``F.pad(mode="reflect")``, ReLU, then
a batch norm with running statistics and an affine part; the Res2 chain
branch by branch; squeeze-excitation; the MFA layer; attentive statistics
pooling with global context; the BN and the FC; cosine scores.  No
batching tricks, and nothing imported from the port or from JAX.

The weights are a state dict under SpeechBrain's ECAPA_TDNN module names
(``blocks.0.conv.conv.weight``, ``blocks.1.res2net_block.blocks.0.norm
.norm.running_var``, ``asp_bn.norm.weight``, ``fc.conv.bias``, ...).
TF32 is off for cuBLAS and cuDNN around every call.
"""

import contextlib

import torch
import torch.nn.functional as F

DILATIONS = (2, 3, 4)
BN_EPS = 1e-5
STATS_EPS = 1e-12


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _bn(x, sd, prefix):
    """Batch norm with running statistics and an affine part, channels on
    axis 1 of (B, C, T) or (B, C)."""
    shape = (1, -1, 1) if x.dim() == 3 else (1, -1)

    def v(name):
        return sd[f"{prefix}.{name}"].view(shape)
    return ((x - v("running_mean")) / torch.sqrt(v("running_var") + BN_EPS)
            * v("weight") + v("bias"))


def _tdnn_block(x, sd, prefix, dilation=1):
    """TB(x; k, d) = BN(ReLU(Conv1d(x))), the convolution "same" with
    reflect padding."""
    w = sd[f"{prefix}.conv.conv.weight"]
    pad = dilation * (w.shape[2] - 1) // 2
    if pad:
        x = F.pad(x, (pad, pad), mode="reflect")
    y = F.conv1d(x, w, sd[f"{prefix}.conv.conv.bias"], dilation=dilation)
    return _bn(F.relu(y), sd, f"{prefix}.norm.norm")


def _conv1x1(x, sd, prefix):
    return F.conv1d(x, sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])


def _se_res2_block(h, sd, prefix, dilation):
    u = _tdnn_block(h, sd, f"{prefix}.tdnn1")
    n_branches = sum(1 for k in sd if k.startswith(
        f"{prefix}.res2net_block.blocks.") and k.endswith(".conv.conv.weight"))
    ys = []
    for i, u_i in enumerate(torch.chunk(u, n_branches + 1, dim=1)):
        if i == 0:
            y = u_i
        elif i == 1:
            y = _tdnn_block(u_i, sd, f"{prefix}.res2net_block.blocks.0",
                            dilation)
        else:
            y = _tdnn_block(u_i + y, sd,
                            f"{prefix}.res2net_block.blocks.{i - 1}",
                            dilation)
        ys.append(y)
    v = _tdnn_block(torch.cat(ys, dim=1), sd, f"{prefix}.tdnn2")
    z = v.mean(dim=2, keepdim=True)
    s = F.relu(_conv1x1(z, sd, f"{prefix}.se_block.conv1.conv"))
    g = torch.sigmoid(_conv1x1(s, sd, f"{prefix}.se_block.conv2.conv"))
    return v * g + h


def _attentive_stats_pool(m, sd):
    t = m.shape[2]
    mu = m.mean(dim=2, keepdim=True)
    sigma = torch.sqrt(torch.clamp((m * m).mean(dim=2, keepdim=True)
                                   - mu * mu, min=STATS_EPS))
    ctx = torch.cat([m, mu.expand(-1, -1, t), sigma.expand(-1, -1, t)],
                    dim=1)
    a = _conv1x1(torch.tanh(_tdnn_block(ctx, sd, "asp.tdnn")), sd,
                 "asp.conv.conv")
    alpha = torch.softmax(a, dim=2)
    mu_t = (alpha * m).sum(dim=2)
    sigma_t = torch.sqrt(torch.clamp(
        (alpha * (m - mu_t[:, :, None]) ** 2).sum(dim=2), min=STATS_EPS))
    return torch.cat([mu_t, sigma_t], dim=1)


def embedding(sd: dict, feats: torch.Tensor) -> torch.Tensor:
    """feats (B, T, F) float32 -> (B, embedding)."""
    with no_tf32():
        h = _tdnn_block(feats.transpose(1, 2), sd, "blocks.0")
        hs = []
        for j, dil in enumerate(DILATIONS, start=1):
            h = _se_res2_block(h, sd, f"blocks.{j}", dil)
            hs.append(h)
        m = _tdnn_block(torch.cat(hs, dim=1), sd, "mfa")
        pooled = _bn(_attentive_stats_pool(m, sd), sd, "asp_bn.norm")
        return _conv1x1(pooled[:, :, None], sd, "fc.conv")[:, :, 0]


def cosine_scores(emb: torch.Tensor, enrolled: torch.Tensor) -> torch.Tensor:
    """(B, D) x (S, D) -> (B, S): each pair's cosine."""
    with no_tf32():
        e = emb / emb.norm(dim=1, keepdim=True)
        s = enrolled / enrolled.norm(dim=1, keepdim=True)
        return e @ s.T


def scores(sd: dict, feats: torch.Tensor, enrolled: torch.Tensor):
    return cosine_scores(embedding(sd, feats), enrolled)
