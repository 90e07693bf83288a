"""Plain float32 reference of xv-PLDA: Kaldi MFCC, sliding CMN, the x-vector
TDNN (Snyder et al., ICASSP 2018: five dilated convolutions, each followed
by ReLU and a batch norm with running statistics and no affine, then mean
and unbiased standard deviation over time and the first affine layer,
whose output is the x-vector), mean subtraction, LDA, length norm and
PLDA scores against the enrolled speakers.

It takes the raw weights the benchmark drew (``models/xv_plda.py``) and
imports nothing of the program.  The convolutions are ``F.conv1d``; TF32
is set off around every call (``common.precision``).
"""

import torch
import torch.nn.functional as F

from benchmark.reference import common, frontend, plda

SCALE = 32768.0   # scale-domain audio in [-1, 1) to Kaldi's int16 range


class Reference:

    def __init__(self, w: dict, cfg: dict, device, precision="float32"):
        self.w = w
        self.cfg = cfg
        self.mfcc = frontend.Mfcc(cfg["frontend"], device)
        self.precision = precision

    def embedding(self, wav: torch.Tensor, dither=None) -> torch.Tensor:
        w, cfg = self.w, self.cfg
        feat = frontend.sliding_cmn(self.mfcc(wav * SCALE, dither),
                                    cfg["frontend"]["cmn_window"])
        x = feat.transpose(1, 2)                            # (B, F, T)
        for i, (_, dil, _) in enumerate(cfg["tdnn"]):
            x = F.relu(F.conv1d(x, w["conv_w"][i], w["conv_b"][i],
                                dilation=dil))
            x = ((x - w["bn_mean"][i][:, None])
                 / torch.sqrt(w["bn_var"][i][:, None] + cfg["bn_eps"]))
        stats = torch.cat([x.mean(-1), x.std(-1, correction=1)], dim=-1)
        return stats @ w["fc1_w"].T + w["fc1_b"]

    def path_context(self, wav, path: dict, block: int):
        """The gradient path freezes nothing per call."""
        return None

    def scores(self, wav: torch.Tensor, dither=None, sel=None):
        """(B, L) scale-domain waves -> (B, S) PLDA scores (``sel``: the
        path's context, always None here)."""
        with common.precision(self.precision):
            emb = plda.process(self.w, self.embedding(wav, dither))
            return plda.llr(self.w, self.w["enroll"], emb)
