"""ECAPA-TDNN speaker embeddings with a cosine backend (CSI-E).

Desplanques, Thienpondt and Demuynck, "ECAPA-TDNN: Emphasized Channel
Attention, Propagation and Aggregation in TDNN Based Speaker Verification",
Interspeech 2020 (arXiv:2005.07143), with the layer order of SpeechBrain's
``speechbrain/lobes/models/ECAPA_TDNN.py``:

    MFCC (80 mel bins, 80 cepstra) -> sliding CMN (window 300)
    TB(x; k, d) = BN_affine(ReLU(Conv1d_{k,d}(x))), "same" convolutions
                  with reflect padding, BN with running statistics
    h0 = TB(X; 5, 1)
    three SE-Res2 blocks j = 1..3, dilations 2, 3, 4:
        u = TB(h_{j-1}; 1, 1); split u into ``scale`` chunks u_1 ..;
        y_1 = u_1, y_2 = TB(u_2; 3, d), y_i = TB(u_i + y_{i-1}; 3, d);
        v = TB(cat y; 1, 1); z = mean_t v;
        g = sigmoid(W2 ReLU(W1 z + b1) + b2); h_j = v g + h_{j-1}
    m = TB(cat(h1, h2, h3); 1, 1)                        (MFA)
    attentive statistics pooling with global context:
        mu, sigma = mean and std of m over time,
        sigma = sqrt(clamp(mean(m^2) - mu^2, 1e-12));
        a = Conv1x1(tanh(TB(cat(m, mu, sigma); 1, 1)));
        alpha = softmax_t(a); mu~ = sum_t alpha m,
        sigma~ = sqrt(clamp(sum_t alpha (m - mu~)^2, 1e-12))
    embedding = FC(BN_affine(cat(mu~, sigma~)))
    scores = cosine of the embedding with each enrolled speaker's

Feature flags: 0 = wav, 1 = raw MFCC, 2 = CMN (the x-vector's ladder: this
front end has no delta step).

The fast attack-gradient path (``FastPath``: ``tdnn_fast`` with
``tdnn_bf16_act``) carries the trunk's activations in bf16 and runs every
TB block in ``models/tdnn.py``'s bf16 form, affine and padded: on the
card one ``tdnn_conv`` launch a direction each (30 a forward), on the CPU
its plain version.  A block outside the Res2 chains is a
``_BlockFastBf16``; each Res2 chain, its seven blocks, adds and cat, is
one autograd node (``_Res2FastBf16``) over the same launches.  The
pooling's softmax over time and weighted statistics are
``ops/asp_pool.py``'s ``AttentiveStats``: on the card one ``asp_stats``
launch a direction.  The rest is plain torch: the Res2 adds and the SE's
h + v g (its gate rounded to bf16) one bf16 pass each, rounded once; the
SE gates, the pooling's context statistics (accumulated in float32 from
the bf16 activations), its attention logits, the head and the cosine in
float32.  The exact path (every final decision) runs each TB as a
float32 im2col GEMM (``ops/tdnn_conv._conv1d``) on the reflect-padded
input, TF32 off.

The weights are buffers in PyTorch's layouts (Conv1d (out, in, k); the SE,
attention and FC 1x1 convolutions as (out, in) matrices);
``load_ecapa_from_torch_state`` reads a state dict under SpeechBrain's
``ECAPA_TDNN`` module names, ``ecapa_torch_state`` writes one.
"""

import functools
import operator
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models.base import (FastPath, NEG_INF, SRSModel,
                                                tree_leaves, tree_rebuild)
from speakerguard_tpu_torch.models.tdnn import _BlockFastBf16, _tensor
from speakerguard_tpu_torch.ops.asp_pool import (AttentiveStats,
                                                 stats_fwd_plain)
from speakerguard_tpu_torch.ops.cmvn import sliding_cmvn
from speakerguard_tpu_torch.ops.kaldi_mfcc import MfccConfig, kaldi_mfcc
from speakerguard_tpu_torch.ops.tdnn_conv import (_cached, _conv1d,
                                                  affine_bn_kept,
                                                  cotangent_rows,
                                                  reflect_rows, same_pad,
                                                  tdnn_conv)
from speakerguard_tpu_torch.utils.profiling import annotate

ECAPA_MFCC = MfccConfig(num_mel_bins=80, num_ceps=80)
DILATIONS = (2, 3, 4)      # the SE-Res2 blocks'; h0 and every 1x1 take 1
STATS_EPS = 1e-12          # the pooling's variance floor (SpeechBrain's)


class BNAffine(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    weight: torch.Tensor     # gamma
    bias: torch.Tensor       # beta


class TBParams(NamedTuple):
    w: torch.Tensor          # (out, in, k)
    b: torch.Tensor          # (out,)
    bn: BNAffine


class SERes2Params(NamedTuple):
    tdnn1: TBParams
    res2: tuple              # scale - 1 x TBParams, k = 3
    tdnn2: TBParams
    se_w1: torch.Tensor      # (se_channels, C)
    se_b1: torch.Tensor
    se_w2: torch.Tensor      # (C, se_channels)
    se_b2: torch.Tensor


class EcapaParams(NamedTuple):
    block0: TBParams
    blocks: tuple            # 3 x SERes2Params
    mfa: TBParams
    asp_tdnn: TBParams       # 3 MFA -> attention channels, k = 1
    asp_w: torch.Tensor      # (MFA, attention channels)
    asp_b: torch.Tensor
    asp_bn: BNAffine         # over 2 MFA
    fc_w: torch.Tensor       # (embedding, 2 MFA)
    fc_b: torch.Tensor


def random_ecapa_params(rng: np.random.Generator, channels: int = 1024,
                        in_dim: int = 80, scale: int = 8,
                        se_channels: int = 128, attention: int = 128,
                        mfa: int = 1536, emb: int = 192,
                        device=None) -> EcapaParams:
    """Random weights from ``rng``: convolutions and linear maps uniform in
    +-1/sqrt(fan_in) (PyTorch's default initialisation), BN running means
    in [0, 0.1], variances and gammas in [0.5, 1.5], betas in +-0.1."""
    dev = resolve_device(device)

    def uni(shape, bound):
        return _tensor(rng.uniform(-bound, bound, shape), dev)

    def bn(c):
        return BNAffine(_tensor(rng.uniform(0.0, 0.1, c), dev),
                        _tensor(rng.uniform(0.5, 1.5, c), dev),
                        _tensor(rng.uniform(0.5, 1.5, c), dev),
                        _tensor(rng.uniform(-0.1, 0.1, c), dev))

    def tb(cin, cout, k):
        bound = 1.0 / np.sqrt(cin * k)
        return TBParams(uni((cout, cin, k), bound), uni(cout, bound),
                        bn(cout))

    def lin(cin, cout):
        bound = 1.0 / np.sqrt(cin)
        return uni((cout, cin), bound), uni(cout, bound)

    width = channels // scale
    blocks = []
    for _ in DILATIONS:
        tdnn1 = tb(channels, channels, 1)
        res2 = tuple(tb(width, width, 3) for _ in range(scale - 1))
        tdnn2 = tb(channels, channels, 1)
        w1, b1 = lin(channels, se_channels)
        w2, b2 = lin(se_channels, channels)
        blocks.append(SERes2Params(tdnn1, res2, tdnn2, w1, b1, w2, b2))
    block0 = tb(in_dim, channels, 5)
    mfa_p = tb(len(DILATIONS) * channels, mfa, 1)
    asp_tdnn = tb(3 * mfa, attention, 1)
    asp_w, asp_b = lin(attention, mfa)
    asp_bn = bn(2 * mfa)
    fc_w, fc_b = lin(2 * mfa, emb)
    return EcapaParams(block0, tuple(blocks), mfa_p, asp_tdnn, asp_w, asp_b,
                       asp_bn, fc_w, fc_b)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def _tb_exact(x, p: TBParams, dilation: int):
    """A TB block on the exact path: float32, the reflect-padded input
    through one im2col GEMM."""
    k = p.w.shape[2]
    if k > 1:
        x = reflect_rows(x, same_pad(k, dilation))
    a, c = affine_bn_kept(*p.bn)
    return F.relu(_conv1d(x, p.w, p.b, dilation)) * a + c


def _tb_fast(x, p: TBParams, dilation: int):
    """A TB block on the fast path: ``_BlockFastBf16`` on bf16 x."""
    bn = p.bn
    return _BlockFastBf16.apply(x, p.w, p.b, bn.mean, bn.var, dilation,
                                bn.weight, bn.bias)


def _res2(u, branches, dilation, tb):
    """The Res2 chain: u's chunks, each branch after the first fed the
    previous branch's output; -> cat y."""
    chunks = u.split(u.shape[-1] // (len(branches) + 1), dim=-1)
    ys = [chunks[0]]
    for i, p in enumerate(branches, start=1):
        ys.append(tb(chunks[i] if i == 1 else chunks[i] + ys[-1], p,
                     dilation))
    return torch.cat(ys, dim=-1)


class _Res2FastBf16(torch.autograd.Function):
    """``_res2`` of ``_tb_fast`` blocks as one autograd node: the same
    ``tdnn_conv`` launches, bf16 adds and cat, with the backward written
    out (each branch's output cotangent its slice of the cat's plus the
    next branch's input cotangent, one bf16 add, as autograd sums them,
    written in the layout the kernel reads), so that a step's host time
    does not go to 7 nodes, 6 adds, their bookkeeping and 6 copies a
    block."""

    @staticmethod
    def forward(ctx, u, branches, dilation):
        width = u.shape[-1] // (len(branches) + 1)
        chunks = u.split(width, dim=-1)
        ys, saved = [chunks[0]], []
        for i, p in enumerate(branches, start=1):
            bn = p.bn
            out, kept = tdnn_conv.forward(
                chunks[i] if i == 1 else chunks[i] + ys[-1], p.w, p.b,
                bn.mean, bn.var, dilation, bn.weight, bn.bias)
            ys.append(out)
            saved.append((kept, bn.weight))
        ctx.saved, ctx.width, ctx.dilation = saved, width, dilation
        return torch.cat(ys, dim=-1)

    @staticmethod
    def backward(ctx, gy):
        gs = gy.split(ctx.width, dim=-1)
        gxs, carry = [gs[0]], None
        for i in range(len(ctx.saved), 0, -1):
            kept, gamma = ctx.saved[i - 1]
            # the sum lands in the layout the backward's kernel reads
            g = gs[i] if carry is None else torch.add(
                gs[i], carry, out=cotangent_rows(kept[0], gs[i].shape))
            gx = tdnn_conv.backward(g, *kept, ctx.dilation, gamma)
            gxs.insert(1, gx)
            carry = gx if i > 1 else None
        return torch.cat(gxs, dim=-1), None, None


def _se(v, blk: SERes2Params):
    """Squeeze-excitation gates (B, C) of v over time, in float32 (the
    mean accumulated in float32 from v as it is)."""
    z = v.mean(dim=1, dtype=torch.float32)
    s = F.relu(F.linear(z, blk.se_w1, blk.se_b1))
    return torch.sigmoid(F.linear(s, blk.se_w2, blk.se_b2))


def _trunk(params: EcapaParams, x, tb, res2):
    """h0, the three SE-Res2 blocks and the MFA layer -> m (B, T, MFA), in
    x's dtype; ``res2(u, branches, dilation)`` the Res2 chain."""
    with annotate("sg.ecapa"):
        h = tb(x, params.block0, 1)
        hs = []
        for blk, dil in zip(params.blocks, DILATIONS):
            u = tb(h, blk.tdnn1, 1)
            with annotate("sg.res2"):
                y = res2(u, blk.res2, dil)
            v = tb(y, blk.tdnn2, 1)
            with annotate("sg.se"):
                # h + v g in one pass, rounded once to x's dtype (the
                # gate rounded to it first)
                h = torch.addcmul(h, v, _se(v, blk)[:, None].to(x.dtype))
            hs.append(h)
        return tb(torch.cat(hs, dim=-1), params.mfa, 1)


def _head(params: EcapaParams, m, tb):
    """Attentive statistics pooling with global context, the BN and the
    FC -> the embedding (B, emb), float32."""
    with annotate("sg.asp"):
        t = m.shape[1]
        # the context's mean and mean square accumulated in float32 from m
        # as it is
        mu = m.mean(dim=1, dtype=torch.float32)
        msq = torch.linalg.vector_norm(m, dim=1, dtype=torch.float32) ** 2 / t
        sigma = torch.sqrt(torch.clamp(msq - mu * mu, min=STATS_EPS))
        ctx = torch.cat([m] + [s.to(m.dtype)[:, None].expand(-1, t, -1)
                               for s in (mu, sigma)], dim=-1)
        z = torch.tanh(tb(ctx, params.asp_tdnn, 1).float())
        logits = F.linear(z, params.asp_w, params.asp_b)
        # softmax over t, the weighted mean and std: one Function on the
        # fast path (ops/asp_pool.py: the kernel on the card), autograd
        # through its plain forward on the exact path
        if m.dtype == torch.bfloat16:
            mu_t, sigma_t = AttentiveStats.apply(logits, m, STATS_EPS)
        else:
            mu_t, sigma_t = stats_fwd_plain(logits, m, STATS_EPS)[:2]
        a, c = affine_bn_kept(*params.asp_bn)
        pooled = torch.cat([mu_t, sigma_t], dim=-1) * a + c
        return F.linear(pooled, params.fc_w, params.fc_b)


def ecapa_embedding(params: EcapaParams, feats: torch.Tensor,
                    fast: FastPath | None = None) -> torch.Tensor:
    """feats (B, T, 80) -> (B, emb).  ``fast`` (a ``FastPath``; None =
    exact): the bf16 blocks when its ``tdnn_fast`` and ``tdnn_bf16_act``
    are set."""
    bf16 = fast is not None and fast.tdnn_fast and fast.tdnn_bf16_act
    tb = _tb_fast if bf16 else _tb_exact
    res2 = (_Res2FastBf16.apply if bf16
            else functools.partial(_res2, tb=_tb_exact))
    x = feats.to(torch.bfloat16) if bf16 else feats
    return _head(params, _trunk(params, x, tb, res2), tb)


def cosine_scores(emb: torch.Tensor, enrolled: torch.Tensor) -> torch.Tensor:
    """(B, D) x (S, D) -> (B, S) cosines (the enrolled side normalised once
    and kept while it takes no gradient)."""
    with annotate("sg.cosine"):
        if enrolled.requires_grad:
            unit = F.normalize(enrolled, dim=-1)
        else:
            unit = _cached(enrolled, "_unit_rows", (enrolled,),
                           lambda: F.normalize(enrolled, dim=-1))
        return F.normalize(emb, dim=-1) @ unit.T


class EcapaCos(SRSModel):
    """ECAPA-TDNN embeddings scored by cosine against the enrolled
    speakers.  The parameters are buffers named by their path in
    ``EcapaParams`` (``blocks__0__res2__3__w``, ...); ``params``
    reassembles the tuples.  Task CSI by default (threshold -inf: argmax
    over the enrolled speakers)."""

    allowed_flags = (0, 1, 2)
    range_type = "origin"

    def __init__(self, params: EcapaParams, model_file: str | None = None,
                 threshold: float | None = None, mfcc_config=ECAPA_MFCC,
                 fast: FastPath | None = None):
        super().__init__()
        self.fast = fast
        self._template = tree_rebuild(params, lambda name: None)
        for name, t in tree_leaves(params):
            self.register_buffer(name, t)
        self.mfcc_config = mfcc_config
        self.threshold = threshold if threshold is not None else NEG_INF
        self._init_enrollment(model_file)

    @property
    def params(self) -> EcapaParams:
        """The weights' tuples, rebuilt only when a buffer was replaced
        (``.to``, ``load_state_dict`` into new tensors): every forward
        reads them, and the rebuild walks some 200 buffers."""
        bufs = tuple(self._buffers.values())
        hit = self.__dict__.get("_params_kept")
        if (hit is None or len(hit[0]) != len(bufs)
                or not all(map(operator.is_, hit[0], bufs))):
            hit = (bufs, tree_rebuild(self._template,
                                      lambda n: getattr(self, n)))
            self.__dict__["_params_kept"] = hit
        return hit[1]

    def _raw(self, wav, rng=None, fast=False):
        fp = self._fast_on(fast)
        return kaldi_mfcc(wav, self.mfcc_config, rng=rng,
                          fast_dft=fp is not None and fp.dft_bf16)

    def _feat_step(self, feats, ori_flag):
        if ori_flag == 1:
            return sliding_cmvn(feats)
        raise ValueError(ori_flag)

    def _embedding_from_top(self, feats, fast=False, fast_ctx=None):
        return ecapa_embedding(self.params, feats, fast=self._fast_on(fast))

    def _scores_from_emb(self, emb, enroll_embs=None):
        return cosine_scores(emb, self._enrolled(enroll_embs))


# ---------------------------------------------------------------------------
# SpeechBrain's state dict
# ---------------------------------------------------------------------------

def _tb_names(prefix: str) -> dict:
    """EcapaParams' TB fields -> SpeechBrain's keys of a TDNNBlock."""
    return {"w": f"{prefix}.conv.conv.weight", "b": f"{prefix}.conv.conv.bias",
            "mean": f"{prefix}.norm.norm.running_mean",
            "var": f"{prefix}.norm.norm.running_var",
            "weight": f"{prefix}.norm.norm.weight",
            "bias": f"{prefix}.norm.norm.bias"}


def _state_items(params: EcapaParams):
    """(SpeechBrain key, tensor in SpeechBrain's shape) of every weight."""
    def tb(prefix, p: TBParams):
        n = _tb_names(prefix)
        yield n["w"], p.w
        yield n["b"], p.b
        for field in BNAffine._fields:
            yield n[field], getattr(p.bn, field)

    def conv1x1(prefix, w, b):
        yield f"{prefix}.weight", w[:, :, None]
        yield f"{prefix}.bias", b

    yield from tb("blocks.0", params.block0)
    for j, blk in enumerate(params.blocks, start=1):
        yield from tb(f"blocks.{j}.tdnn1", blk.tdnn1)
        for i, p in enumerate(blk.res2):
            yield from tb(f"blocks.{j}.res2net_block.blocks.{i}", p)
        yield from tb(f"blocks.{j}.tdnn2", blk.tdnn2)
        yield from conv1x1(f"blocks.{j}.se_block.conv1.conv", blk.se_w1,
                           blk.se_b1)
        yield from conv1x1(f"blocks.{j}.se_block.conv2.conv", blk.se_w2,
                           blk.se_b2)
    yield from tb("mfa", params.mfa)
    yield from tb("asp.tdnn", params.asp_tdnn)
    yield from conv1x1("asp.conv.conv", params.asp_w, params.asp_b)
    for field, key in zip(BNAffine._fields, ("running_mean", "running_var",
                                              "weight", "bias")):
        yield f"asp_bn.norm.{key}", getattr(params.asp_bn, field)
    yield from conv1x1("fc.conv", params.fc_w, params.fc_b)


def ecapa_torch_state(params: EcapaParams) -> dict:
    """A state dict of ``params`` under SpeechBrain's ECAPA_TDNN names
    (CPU tensors)."""
    return {k: v.detach().cpu().clone() for k, v in _state_items(params)}


def load_ecapa_from_torch_state(state: dict, device=None) -> EcapaParams:
    """EcapaParams from a SpeechBrain ECAPA_TDNN state dict (tensors or
    numpy arrays; a path that ``torch.load`` reads is taken too).  The
    widths come from the tensors' shapes; the dilations are 2, 3, 4."""
    dev = resolve_device(device)
    if not isinstance(state, dict):
        state = torch.load(state, map_location="cpu")

    def arr(k):
        v = state[k]
        return _tensor(v.detach().cpu().numpy() if hasattr(v, "detach")
                       else v, dev)

    def tb(prefix):
        n = _tb_names(prefix)
        return TBParams(arr(n["w"]), arr(n["b"]), BNAffine(
            *(arr(n[f]) for f in BNAffine._fields)))

    def conv1x1(prefix):
        return arr(f"{prefix}.weight")[:, :, 0], arr(f"{prefix}.bias")

    blocks = []
    for j in range(1, len(DILATIONS) + 1):
        n_res2 = sum(1 for k in state if k.startswith(
            f"blocks.{j}.res2net_block.blocks.") and k.endswith(
            ".conv.conv.weight"))
        res2 = tuple(tb(f"blocks.{j}.res2net_block.blocks.{i}")
                     for i in range(n_res2))
        w1, b1 = conv1x1(f"blocks.{j}.se_block.conv1.conv")
        w2, b2 = conv1x1(f"blocks.{j}.se_block.conv2.conv")
        blocks.append(SERes2Params(tb(f"blocks.{j}.tdnn1"), res2,
                                   tb(f"blocks.{j}.tdnn2"), w1, b1, w2, b2))
    asp_w, asp_b = conv1x1("asp.conv.conv")
    fc_w, fc_b = conv1x1("fc.conv")
    asp_bn = BNAffine(*(arr(f"asp_bn.norm.{k}") for k in (
        "running_mean", "running_var", "weight", "bias")))
    return EcapaParams(tb("blocks.0"), tuple(blocks), tb("mfa"),
                       tb("asp.tdnn"), asp_w, asp_b, asp_bn, fc_w, fc_b)
