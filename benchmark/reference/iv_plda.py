"""Plain float32 reference of iv-PLDA: Kaldi MFCC with deltas and sliding
CMN, Baum-Welch statistics of a full-covariance UBM, the i-vector and PLDA
scores against the enrolled speakers.

    loglike[t, c] = gconst_c + mic_c . x_t - x_t' P_c x_t / 2
                    (mic_c = P_c mu_c, P_c the inverse covariance)
    N_c = sum_t post[t, c]              F_c = sum_t post[t, c] x_t
    L = I + sum_c N_c M_c' S_c M_c      (S_c the extractor's Sigma_c^-1)
    w = L^-1 (sum_c M_c' S_c F_c + o e_1) - o e_1

with Kaldi's prior offset o on the first coordinate (ivector-extract, as
SpeakerGuard's reference ivector_extract.py computes it).  The quadratic
form is one product of the full outer product x x' against each P_c, the
solve is ``torch.linalg.cholesky`` and ``cholesky_solve``.  It takes the
raw weights the benchmark drew (``models/iv_plda.py``), works out the
derived matrices itself and imports nothing of the program.
"""

import torch

from benchmark.reference import common, frontend, plda

SCALE = 32768.0


class Reference:

    def __init__(self, w: dict, cfg: dict, device, precision="float32"):
        self.w = w
        self.cfg = cfg
        self.precision = precision
        self.mfcc = frontend.Mfcc(cfg["frontend"], device)
        m, s = w["M"], w["sigma_inv"]
        c, d, iv = m.shape
        with common.precision(precision):
            # M_c' S_c (C, IV, D) and M_c' S_c M_c (C, IV * IV), in groups
            # of components to bound the temporaries
            self.ms = torch.einsum("cdi,cde->cie", m, s)
            self.quad = torch.cat([
                torch.bmm(self.ms[g:g + 256], m[g:g + 256]).reshape(-1,
                                                                    iv * iv)
                for g in range(0, c, 256)])
        self.prec_flat = w["invcov"].reshape(c, d * d)
        self.iv = iv

    def features(self, wav, dither=None):
        fe = self.cfg["frontend"]
        feat = self.mfcc(wav * SCALE, dither)
        feat = frontend.add_deltas(feat, fe["delta_window"], fe["delta_order"])
        return frontend.sliding_cmn(feat, fe["cmn_window"])

    def posteriors(self, feat, sel=None):
        """(B, T, C) component posteriors of each frame, over the
        components ``sel`` (all when None)."""
        w = self.w
        b, t, d = feat.shape
        g, m, p = w["gconsts"], w["mic"], self.prec_flat
        if sel is not None:
            g, m, p = g[sel], m[sel], p[sel]
        outer = (feat[..., :, None] * feat[..., None, :]).reshape(b, t, d * d)
        return torch.softmax(g + feat @ m.T - 0.5 * (outer @ p.T), dim=-1)

    def ivector(self, zeroth, first, sel=None):
        b, iv = zeroth.shape[0], self.iv
        quad, ms = ((self.quad, self.ms) if sel is None
                    else (self.quad[sel], self.ms[sel]))
        eye = torch.eye(iv, device=zeroth.device, dtype=zeroth.dtype)
        lmat = eye + (zeroth @ quad).view(b, iv, iv)
        offset = torch.zeros(iv, device=zeroth.device, dtype=zeroth.dtype)
        offset[0] = self.w["offset"]
        rhs = torch.einsum("cid,bcd->bi", ms, first) + offset
        chol = torch.linalg.cholesky(lmat)
        return torch.cholesky_solve(rhs[..., None], chol)[..., 0] - offset

    def scores(self, wav: torch.Tensor, dither=None, sel=None):
        """(B, L) scale-domain waves -> (B, S) PLDA scores; with ``sel``,
        of the model restricted to those UBM components (the statistics
        and the i-vector over them alone)."""
        with common.precision(self.precision):
            feat = self.features(wav, dither)
            post = self.posteriors(feat, sel)
            zeroth = post.sum(1)
            first = torch.einsum("btc,btd->bcd", post, feat)
            emb = plda.process(self.w, self.ivector(zeroth, first, sel))
            return plda.llr(self.w, self.w["enroll"], emb)

    @torch.no_grad()
    def path_context(self, wav: torch.Tensor, path: dict, block: int):
        """What the attack's gradient path freezes for a call from its
        clean waves: with ``gmm_topk`` K (0 < K < C), the K components of
        largest share of an utterance's posterior mass, the largest share
        over the call's utterances taken (no dither); else None."""
        k = path.get("gmm_topk", 0)
        if not 0 < k < self.w["gconsts"].shape[0]:
            return None
        with common.precision(self.precision):
            share = torch.cat([
                self.posteriors(self.features(wav[s:s + block])).mean(1)
                for s in range(0, wav.shape[0], block)])
        return torch.topk(share.amax(0), k).indices
