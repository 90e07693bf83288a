"""Plain float32 reference of ECAPA-TDNN with a cosine backend: Kaldi MFCC
(80 mel bins, 80 cepstra), sliding CMN, then the network of Desplanques,
Thienpondt and Demuynck (Interspeech 2020, arXiv:2005.07143) in the layer
order of SpeechBrain's ECAPA_TDNN: TDNN blocks BN(ReLU(Conv1d(x))) with
reflect padding and an affine batch norm with running statistics, three
SE-Res2 blocks, the MFA layer, attentive statistics pooling with global
context, BN and FC to the embedding; cosine scores against the enrolled
speakers.

It takes the raw weights the benchmark drew (``models/ecapa_tdnn.py``,
named as SpeechBrain's state dict) and imports nothing of the program.
The convolutions are ``F.conv1d`` on inputs padded with ``F.pad(mode=
"reflect")``, on (B, C, T) tensors; TF32 is set off around every call
(``common.precision``).

The front end is ``frontend.py``'s (framing, dither, DC removal, log
energy, mel bank, DCT, lifter, sliding CMN) but for its spectrum: at 80
mel bins the lowest filters span about one DFT bin, where the
pre-emphasis leaves a thousandth of the frame's energy, and an FFT of the
pre-emphasised frame errs in float32 by the whole frame's scale there (the
features 4e-3 of their largest from float64's on the card).  So the power
spectrum is the DFT as one product, the pre-emphasis and the window
folded into its cosine and sine matrices, built in float64: each bin errs
at its own scale.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import common, frontend

SCALE = 32768.0   # scale-domain audio in [-1, 1) to Kaldi's int16 range


class DftMfcc(frontend.Mfcc):
    """``frontend.Mfcc`` with the power spectrum of each frame as
    (x C)^2 + (x S)^2: C[n, k] and S[n, k] the cosine and sine of bin k
    applied to the windowed, pre-emphasised frame, as a matrix on the raw
    frame x."""

    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        win = self.window.shape[0]
        a = cfg["preemphasis"]
        # y = P x: y[0] = (1 - a) x[0], y[m] = x[m] - a x[m - 1]
        pre = np.eye(win)
        pre[0, 0] = 1.0 - a
        pre[np.arange(1, win), np.arange(win - 1)] = -a
        i = np.arange(win)
        povey = (0.5 - 0.5 * np.cos(2 * math.pi * i / (win - 1))) ** 0.85
        ang = 2 * math.pi * np.outer(i, np.arange(self.n_fft // 2 + 1)) \
            / self.n_fft
        fold = pre.T * povey[None, :]          # x -> window * (P x)
        self.cos_t = torch.tensor(fold @ np.cos(ang), dtype=torch.float32,
                                  device=device)
        self.sin_t = torch.tensor(fold @ np.sin(ang), dtype=torch.float32,
                                  device=device)

    def __call__(self, wav: torch.Tensor, dither=None) -> torch.Tensor:
        cfg = self.cfg
        win, shift, _, t = frontend.geometry(cfg, wav.shape[1])
        idx = torch.as_tensor(frontend._frame_index(wav.shape[1], win,
                                                    shift, t),
                              device=wav.device)
        fr = wav[:, idx]                                    # (B, T, win)
        if dither is not None and cfg["dither"] != 0.0:
            fr = fr + cfg["dither"] * dither
        fr = fr - fr.mean(dim=-1, keepdim=True)
        log_energy = torch.log(torch.clamp((fr * fr).sum(-1),
                                           min=frontend.EPS))
        power = (fr @ self.cos_t) ** 2 + (fr @ self.sin_t) ** 2
        mel = torch.log(torch.clamp(power @ self.bank_t, min=frontend.EPS))
        ceps = (mel @ self.dct_t) * self.lifter
        return torch.cat([log_energy[..., None], ceps[..., 1:]], dim=-1)


class Reference:

    def __init__(self, w: dict, cfg: dict, device, precision="float32"):
        self.w = w
        self.cfg = cfg
        self.mfcc = DftMfcc(cfg["frontend"], device)
        self.precision = precision

    def _bn(self, x, prefix):
        shape = (1, -1, 1) if x.dim() == 3 else (1, -1)

        def v(name):
            return self.w[f"{prefix}.{name}"].view(shape)
        return ((x - v("running_mean"))
                / torch.sqrt(v("running_var") + self.cfg["bn_eps"])
                * v("weight") + v("bias"))

    def _conv(self, x, prefix, dilation=1):
        w = self.w[f"{prefix}.weight"]
        pad = dilation * (w.shape[2] - 1) // 2
        if pad:
            x = F.pad(x, (pad, pad), mode="reflect")
        return F.conv1d(x, w, self.w[f"{prefix}.bias"], dilation=dilation)

    def _tdnn(self, x, prefix, dilation=1):
        return self._bn(F.relu(self._conv(x, f"{prefix}.conv.conv",
                                          dilation)), f"{prefix}.norm.norm")

    def _se_res2(self, h, prefix, dilation):
        scale = self.cfg["res2net_scale"]
        u = self._tdnn(h, f"{prefix}.tdnn1")
        ys = []
        for i, u_i in enumerate(torch.chunk(u, scale, dim=1)):
            branch = f"{prefix}.res2net_block.blocks.{i - 1}"
            if i == 0:
                y = u_i
            elif i == 1:
                y = self._tdnn(u_i, branch, dilation)
            else:
                y = self._tdnn(u_i + y, branch, dilation)
            ys.append(y)
        v = self._tdnn(torch.cat(ys, dim=1), f"{prefix}.tdnn2")
        z = v.mean(dim=2, keepdim=True)
        s = F.relu(self._conv(z, f"{prefix}.se_block.conv1.conv"))
        g = torch.sigmoid(self._conv(s, f"{prefix}.se_block.conv2.conv"))
        return v * g + h

    def _pool(self, m):
        eps, t = self.cfg["stats_eps"], m.shape[2]
        mu = m.mean(dim=2, keepdim=True)
        sigma = torch.sqrt(torch.clamp((m * m).mean(dim=2, keepdim=True)
                                       - mu * mu, min=eps))
        ctx = torch.cat([m, mu.expand(-1, -1, t), sigma.expand(-1, -1, t)],
                        dim=1)
        a = self._conv(torch.tanh(self._tdnn(ctx, "asp.tdnn")),
                       "asp.conv.conv")
        alpha = torch.softmax(a, dim=2)
        mu_t = (alpha * m).sum(dim=2)
        sigma_t = torch.sqrt(torch.clamp(
            (alpha * (m - mu_t[:, :, None]) ** 2).sum(dim=2), min=eps))
        return torch.cat([mu_t, sigma_t], dim=1)

    def embedding_from_feats(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, T, F) features -> (B, embedding)."""
        dil = self.cfg["dilations"]
        h = self._tdnn(feat.transpose(1, 2), "blocks.0", dil[0])
        hs = []
        for j in range(1, len(dil) - 1):
            h = self._se_res2(h, f"blocks.{j}", dil[j])
            hs.append(h)
        m = self._tdnn(torch.cat(hs, dim=1), "mfa", dil[-1])
        pooled = self._bn(self._pool(m), "asp_bn.norm")
        return self._conv(pooled[:, :, None], "fc.conv")[:, :, 0]

    def embedding(self, wav: torch.Tensor, dither=None) -> torch.Tensor:
        feat = frontend.sliding_cmn(self.mfcc(wav * SCALE, dither),
                                    self.cfg["frontend"]["cmn_window"])
        return self.embedding_from_feats(feat)

    def path_context(self, wav, path: dict, block: int):
        """The gradient path freezes nothing per call."""
        return None

    def scores(self, wav: torch.Tensor, dither=None, sel=None):
        """(B, L) scale-domain waves -> (B, S) cosine scores (``sel``: the
        path's context, always None here)."""
        with common.precision(self.precision):
            emb = self.embedding(wav, dither)
            e = emb / emb.norm(dim=1, keepdim=True)
            enroll = self.w["enroll"]
            s = enroll / enroll.norm(dim=1, keepdim=True)
            return e @ s.T
