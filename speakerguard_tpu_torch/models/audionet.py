"""AudioNet CNN for CSI-NE (closed-set identification, no enrolled speakers).

Port of speakerguard_tpu/models/audionet.py (reference
model/audionet_csine.py, an adaption of AudioNet, arXiv:1807.03418): a 5x5
2D pre-filter conv + BN, 7 Conv1d/BN/ReLU blocks with three /2 max-pools,
the repeat-if-too-short trick (audionet_csine.py:195-203), max-over-time
pooling, and a linear classifier head whose logits are the scores.

The functional core keeps the JAX package's boundary layout, features
(B, T, F=32), and runs in torch's own layouts inside: conv1 on (B, 1, F, T)
with an OIHW weight (H = the mel axis), the blocks on (B, C, T) with
(out, in, k) weights.  fc_w keeps the JAX (32, num_class) layout, so the
scores are ``emb @ fc_w + fc_b``.  BatchNorm is written as the JAX
expression, not ``F.batch_norm``, so the bf16 path rounds where JAX rounds;
train mode normalises with the batch mean and biased variance and moves
the running variance toward the unbiased one (momentum 0.1, torch's
default).  The max-pools and the max over time use ``amax``, whose
gradient is shared equally among tied maxima as ``jnp.max``'s is
(``F.max_pool1d`` and ``torch.max(dim)`` send it all to one index).

The fast attack-gradient path (``FastPath.audionet_bf16``, JAX
SG_AUDIONET_BF16) runs the CNN with bf16 weights, running stats and
features, on the CPU too, as the JAX package does: autograd then saves
bf16 activations and passes bf16 cotangents, and each convolution sums in
float32 and rounds once.  The embedding comes back float32 and the fc head
stays float32.  ``FastPath.dft_bf16`` picks the bf16 DFT of the log-mel
frontend.  The model has no per-run fast context.

Feature flags (audionet_csine.py:127-129): 0=wav, 1=raw log-mel feature.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from speakerguard_tpu_torch import resolve_device
from speakerguard_tpu_torch.models.base import (NEG_INF, FastPath, SRSModel,
                                                tree_leaves, tree_rebuild)
from speakerguard_tpu_torch.ops.logmel import AUDIONET_LOGMEL, audionet_logmel
from speakerguard_tpu_torch.parallel.mesh import all_reduce_sum

# conv1d blocks: (cin, cout, kernel, padding, maxpool)
CONV_SPEC = (
    (32, 64, 3, 1, True),    # conv2
    (64, 128, 3, 1, False),  # conv3
    (128, 128, 3, 1, False),  # conv4
    (128, 128, 3, 1, True),  # conv5
    (128, 128, 3, 1, False),  # conv6
    (128, 64, 3, 1, True),   # conv7
    (64, 32, 3, 0, False),   # conv8 (valid padding)
)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class AudioNetParams(NamedTuple):
    conv1_w: torch.Tensor   # (1, 1, 5, 5) OIHW, H = the mel axis
    conv1_b: torch.Tensor   # (1,)
    conv1_gamma: torch.Tensor
    conv1_beta: torch.Tensor
    conv_w: tuple           # 7 x (cout, cin, k)
    conv_b: tuple
    gamma: tuple
    beta: tuple
    fc_w: torch.Tensor      # (32, num_class)
    fc_b: torch.Tensor


class AudioNetState(NamedTuple):
    conv1_mean: torch.Tensor
    conv1_var: torch.Tensor
    means: tuple
    vars: tuple


def from_jax_layout(params, state, device=None
                    ) -> tuple[AudioNetParams, AudioNetState]:
    """The port's pair from arrays in the JAX package's layouts (anything
    with the field names of ``AudioNetParams`` / ``AudioNetState``):
    conv1's HWIO (5, 5, 1, 1) becomes OIHW, each block's (k, cin, cout)
    becomes (cout, cin, k), every other field is carried as it is, all
    float32 on ``device``.  ``params`` may also be a tree of Adam moments
    shaped like the parameters; with ``state`` None the state comes back
    None."""
    dev = resolve_device(device)

    def t(a, axes=None):
        a = np.asarray(a, np.float32)
        return torch.tensor(a if axes is None else a.transpose(axes),
                            device=dev)

    def ts(seq):
        return tuple(t(a) for a in seq)

    net = AudioNetParams(
        t(params.conv1_w, (3, 2, 0, 1)), t(params.conv1_b),
        t(params.conv1_gamma), t(params.conv1_beta),
        tuple(t(w, (2, 1, 0)) for w in params.conv_w), ts(params.conv_b),
        ts(params.gamma), ts(params.beta), t(params.fc_w), t(params.fc_b))
    if state is None:
        return net, None
    return net, AudioNetState(t(state.conv1_mean), t(state.conv1_var),
                              ts(state.means), ts(state.vars))


def to_jax_layout(params: AudioNetParams, state: AudioNetState
                  ) -> tuple[AudioNetParams, AudioNetState]:
    """The inverse of ``from_jax_layout``: the pair as float32 numpy arrays
    in the JAX package's layouts (conv1 HWIO, each block (k, cin, cout)),
    held in the port's tuple types.  ``params`` may also be a tree of Adam
    moments shaped like the parameters; ``state`` may be None."""
    def a(t, axes=None):
        n = t.detach().to(torch.float32).cpu().numpy()
        return np.ascontiguousarray(n if axes is None else n.transpose(axes))

    def arrs(seq):
        return tuple(a(t) for t in seq)

    net = AudioNetParams(
        a(params.conv1_w, (2, 3, 1, 0)), a(params.conv1_b),
        a(params.conv1_gamma), a(params.conv1_beta),
        tuple(a(w, (2, 1, 0)) for w in params.conv_w), arrs(params.conv_b),
        arrs(params.gamma), arrs(params.beta), a(params.fc_w), a(params.fc_b))
    if state is None:
        return net, None
    return net, AudioNetState(a(state.conv1_mean), a(state.conv1_var),
                              arrs(state.means), arrs(state.vars))


def init_audionet(rng: np.random.Generator, num_class: int, device=None
                  ) -> tuple[AudioNetParams, AudioNetState]:
    """Random weights drawn from ``rng`` in the JAX package's order and
    shapes (conv1_w, conv1_b, then each block's w and b, then fc_w, fc_b;
    uniform in +-1/sqrt(fan_in)): one seed gives the same weights in both
    packages.  BN scales 1, shifts 0, running means 0 and variances 1."""
    def u(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape)

    conv1_w = u((5, 5, 1, 1), 25)
    conv1_b = u((1,), 25)
    ws, bs = [], []
    for cin, cout, k, _, _ in CONV_SPEC:
        ws.append(u((k, cin, cout), cin * k))
        bs.append(u((cout,), cin * k))
    couts = [spec[1] for spec in CONV_SPEC]
    ones = [np.ones(c) for c in couts]
    zeros = [np.zeros(c) for c in couts]
    params = AudioNetParams(conv1_w, conv1_b, np.ones(1), np.zeros(1), ws,
                            bs, ones, zeros, u((32, num_class), 32),
                            u((num_class,), 32))
    state = AudioNetState(np.zeros(1), np.ones(1), zeros, ones)
    return from_jax_layout(params, state, device)


def _bn(x, gamma, beta, mean, var, train, sync=None):
    """BatchNorm over every axis of ``x`` but the channel axis 1.  Returns
    (y, batch mean, unbiased batch variance); the batch stats are None in
    eval mode.

    Train mode in a low-precision dtype rounds where JAX does: jnp.mean and
    jnp.var sum and divide in float32 and round once to the dtype (the
    variance of the float32-centred input), and the unbiased rescale
    multiplies by a numpy float64 scalar, which JAX promotes to float32, so
    that the unbiased variance, and the running variance moved toward it,
    come back float32.  In float32 (and float64) all of this is the plain
    expression.

    ``sync`` = (process group, rows of the global batch) makes train mode
    take the global batch's statistics, as JAX's sharded step does: the
    float32 sums, and then the sums of the squares around the global mean,
    are all-reduced with gradient over the group, and the unbiased rescale
    counts the global batch."""
    dims = (0,) + tuple(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    gamma, beta = gamma.view(shape), beta.view(shape)
    if train:
        wide = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(wide)
        if sync is None:
            n = x.numel() // x.shape[1]
            mf = xf.mean(dim=dims)
            cf = xf - mf.view(shape)
            v = (cf * cf).mean(dim=dims).to(x.dtype)  # biased, as jnp.var
        else:
            group, rows = sync
            n = rows * (x.numel() // max(x.shape[0] * x.shape[1], 1))
            mf = all_reduce_sum(xf.sum(dim=dims), group) / n
            cf = xf - mf.view(shape)
            v = (all_reduce_sum((cf * cf).sum(dim=dims), group) / n).to(
                x.dtype)
        m = mf.to(x.dtype)
        y = (x - m.view(shape)) * torch.rsqrt(v.view(shape) + BN_EPS) \
            * gamma + beta
        return y, m, v.to(wide) * (n / max(n - 1, 1))
    y = ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
         * gamma + beta)
    return y, None, None


def _running(old, batch):
    return (1 - BN_MOMENTUM) * old + BN_MOMENTUM * batch


def _maxpool1d(x):
    """(B, C, T) -> (B, C, T//2), torch MaxPool1d(2, 2) semantics (an odd
    tail frame is dropped), with tied maxima sharing the gradient."""
    b, c, t = x.shape
    return x[:, :, :2 * (t // 2)].reshape(b, c, t // 2, 2).amax(dim=-1)


def audionet_embedding(params: AudioNetParams, state: AudioNetState,
                       feats: torch.Tensor, train: bool = False, sync=None):
    """feats: (B, T, F=32) -> ((B, 32) embedding, new_state).  The dtype of
    ``feats`` and of the tensors of ``params`` and ``state`` (one dtype for
    all) is the dtype of the whole chain.  ``sync``: train-mode BN over a
    global batch (``_bn``)."""
    new_m, new_v = list(state.means), list(state.vars)

    # 2D pre-filter on (B, 1, F, T); JAX adds the bias after the conv
    x = feats.transpose(1, 2)[:, None]
    x = F.conv2d(x, params.conv1_w, padding=2) + params.conv1_b.view(
        1, -1, 1, 1)
    x, bm, bv = _bn(x, params.conv1_gamma, params.conv1_beta,
                    state.conv1_mean, state.conv1_var, train, sync)
    c1_m, c1_v = state.conv1_mean, state.conv1_var
    if train:
        c1_m, c1_v = _running(c1_m, bm), _running(c1_v, bv)
    x = x[:, 0]                                        # (B, C=32, T)

    for i, (_, _, _, pad, pool) in enumerate(CONV_SPEC):
        if i == len(CONV_SPEC) - 1 and x.shape[2] < 3:
            # repeat-if-too-short before the valid-padding conv8
            x = x.repeat(1, 1, -(-3 // x.shape[2]))
        x = F.conv1d(x, params.conv_w[i], padding=pad) + params.conv_b[i][
            :, None]
        x, bm, bv = _bn(x, params.gamma[i], params.beta[i], state.means[i],
                        state.vars[i], train, sync)
        if train:
            new_m[i] = _running(state.means[i], bm)
            new_v[i] = _running(state.vars[i], bv)
        x = F.relu(x)
        if pool:
            x = _maxpool1d(x)

    emb = x.amax(dim=2)                                # max over time
    return emb, AudioNetState(c1_m, c1_v, tuple(new_m), tuple(new_v))


def audionet_logits(params: AudioNetParams, state: AudioNetState,
                    feats: torch.Tensor, train: bool = False, sync=None):
    """-> (logits (B, num_class), embedding, new_state)."""
    emb, new_state = audionet_embedding(params, state, feats, train, sync)
    return emb @ params.fc_w + params.fc_b, emb, new_state


def load_audionet_from_torch_state(state: dict, device=None
                                   ) -> tuple[AudioNetParams, AudioNetState]:
    """The pair from a state dict in the reference layout (tensors or numpy
    arrays; audionet_csine.py: conv1 Sequential(Conv2d, BatchNorm2d),
    conv2..conv8 Sequential(Conv1d, BatchNorm1d, ...), fc Linear).  The
    convolution weights keep their layout; the Linear (out, in) weight is
    transposed to (in, out)."""
    dev = resolve_device(device)

    def arr(k):
        v = state[k]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
        return torch.tensor(np.asarray(v, np.float32), device=dev)

    def blocks(suffix):
        return tuple(arr(f"conv{i}.{suffix}") for i in range(2, 9))

    params = AudioNetParams(
        arr("conv1.0.weight"), arr("conv1.0.bias"), arr("conv1.1.weight"),
        arr("conv1.1.bias"), blocks("0.weight"), blocks("0.bias"),
        blocks("1.weight"), blocks("1.bias"), arr("fc.weight").T.contiguous(),
        arr("fc.bias"))
    bstate = AudioNetState(arr("conv1.1.running_mean"),
                           arr("conv1.1.running_var"),
                           blocks("1.running_mean"), blocks("1.running_var"))
    return params, bstate


def parse_label_encoder(path: str):
    """Reference label-encoder txt: rows of 'spk_id' label
    (audionet_csine.py:37-48).  Returns ordered spk_ids list."""
    id_label = np.loadtxt(path, dtype=str,
                          converters={0: lambda s: s[1:-1]})
    label2id = {int(row[1]): row[0] for row in id_label}
    return [label2id[i] for i in range(len(label2id))]


class AudioNet(SRSModel):
    """The parameters and running stats are registered as buffers named by
    their path (``net__conv_w__0``, ``state__means__0``, ...) so
    ``.to(device)`` moves them; ``params`` reassembles the pair."""

    allowed_flags = (0, 1)
    range_type = "scale"
    threshold = NEG_INF  # CSI-NE never rejects

    def __init__(self, params: AudioNetParams, state: AudioNetState,
                 spk_ids=None, logmel_config=AUDIONET_LOGMEL,
                 fast: FastPath | None = None):
        super().__init__()
        self.fast = fast
        self._templates = (tree_rebuild(params, lambda n: None, "net"),
                           tree_rebuild(state, lambda n: None, "state"))
        for name, t in [*tree_leaves(params, "net"),
                        *tree_leaves(state, "state")]:
            self.register_buffer(name, t)
        self.logmel_config = logmel_config
        num_class = int(params.fc_b.shape[0])
        self.spk_ids = (list(spk_ids) if spk_ids is not None
                        else [str(i) for i in range(num_class)])

    def _pair(self, dtype=None):
        """(net params, BN running stats) from the buffers, each cast to
        ``dtype`` when one is given."""
        def get(name):
            t = getattr(self, name)
            return t if dtype is None else t.to(dtype)
        net, state = self._templates
        return tree_rebuild(net, get, "net"), tree_rebuild(state, get, "state")

    @property
    def params(self) -> tuple[AudioNetParams, AudioNetState]:
        """(net params, BN running stats), the JAX ``AudioNet.params``."""
        return self._pair()

    def _raw(self, wav, rng=None, fast=False):
        fp = self._fast_on(fast)
        return audionet_logmel(wav, self.logmel_config,
                               fast_dft=fp is not None and fp.dft_bf16)

    def _feat_step(self, feats, ori_flag):
        raise ValueError("audionet has no feature ladder above flag 1")

    def _embedding_from_top(self, feats, fast=False, fast_ctx=None):
        fp = self._fast_on(fast)
        if fp is not None and fp.audionet_bf16:
            net16, state16 = self._pair(torch.bfloat16)
            emb, _ = audionet_embedding(net16, state16,
                                        feats.to(torch.bfloat16))
            return emb.to(torch.float32)
        emb, _ = audionet_embedding(*self.params, feats)
        return emb

    def _scores_from_emb(self, emb, enroll_embs=None):
        # enroll_embs unused: CSI-NE scores are classifier logits
        return emb @ self.net__fc_w + self.net__fc_b

    def predict_from_embeddings(self, emb):
        """Reference-API alias (audionet_csine.py:210-211)."""
        return self._scores_from_emb(emb)
