"""The fast path's Kaldi MFCC as one kernel a direction (``csrc/mfcc.cu``),
and the plain torch mirror of the kernel's arithmetic.

On a CUDA tensor with ``fast_dft=True``, ``kaldi_mfcc`` runs its chain from
the framing gather to the energy column as ``mfcc`` below: one autograd
node whose forward is ``mfcc_fwd_kernel`` and whose backward is
``mfcc_bwd_gm_kernel`` then ``mfcc_bwd_kernel`` (the source's header says
how); each wrapper counts one launch a call.  The mathematics and
precision are the fast path's: framing, dither, DC removal and energy in
float32, the DFT's operands in bf16 (the frames after DC removal, the
matrices, and in the backward gP re and gP im) with float32 sums, and
power, mel, log, DCT and lifter in float32.  Three facts shape it:

- Bins 0-255 are all the work: the mel bank's Nyquist column is zero and
  the sine of bin 0 is exactly zero (``_consts`` asserts both), so the
  DFT is a (512, 400) bf16 matrix, in chunks of 128 rows: the cosines of
  64 bins, then the negated sines of the same bins.
- Each bin feeds at most two neighbouring mel filters, so the mel product
  is a short sum, forward and backward.
- The backward's two DFT products are one: [bf16(gP re), bf16(gP im)] in
  the chunks' order, K = 512, against the transposed matrix.

``mfcc_fwd_plain`` and ``mfcc_bwd_plain`` repeat that arithmetic in plain
torch (the sums in another order), with the DFT's operands in ``dtype``,
by default the fast path's for the device (``fast_dot_dtype``: bf16 on the
card, float32 on the CPU).  On the card they are the kernels' yardstick
(the card tests, ``chip_smoke.py``); the wrappers take them for CPU
tensors.  ``kaldi_mfcc`` on the CPU and its exact path never come here.
"""

import functools

import numpy as np
import torch

from speakerguard_tpu_torch.ops._build import (FLT, INT, PTR, KernelWrapper,
                                               Library)
from speakerguard_tpu_torch.ops.kaldi_mfcc import (EPSILON, MfccConfig,
                                                   _frame_index, dct_matrix,
                                                   dft_matrices,
                                                   feature_window,
                                                   lifter_coeffs, mel_banks,
                                                   num_frames)
from speakerguard_tpu_torch.ops.matmul import fast_dot_dtype

WINDOW, SHIFT, N_FFT = 400, 160, 512   # the one framing the kernel takes
CHUNK = 64         # bins of a DFT chunk: its cosine rows, then its sines
BINS = 256         # bins 0-255: the Nyquist bin (zero mel weight) dropped
MAX_MEL = 96       # csrc/mfcc.cu's shared-memory plan


def check_config(cfg: MfccConfig):
    """Raise unless the kernel computes ``cfg``'s chain: 400-sample frames
    every 160 samples padded to 512, Kaldi's mirrored edges, DC removal,
    raw energy in column 0 without a floor, Kaldi's mel bank, at most
    MAX_MEL filters and no more cepstra than filters."""
    bad = []
    if (cfg.window_size, cfg.window_shift,
            cfg.padded_window_size) != (WINDOW, SHIFT, N_FFT):
        bad.append("a framing other than 400 / 160 / 512 samples")
    if cfg.snip_edges:
        bad.append("snip_edges")
    if not cfg.remove_dc_offset:
        bad.append("no DC removal")
    if not cfg.use_energy:
        bad.append("energy off")
    if cfg.energy_floor != 0.0:
        bad.append("an energy floor")
    if cfg.htk_compat:
        bad.append("htk_compat")
    if not 1 <= cfg.num_ceps <= cfg.num_mel_bins <= MAX_MEL:
        bad.append(f"{cfg.num_ceps} cepstra of {cfg.num_mel_bins} mel bins")
    if bad:
        raise ValueError("the MFCC kernel does not cover this "
                         "configuration: " + ", ".join(bad))


def dft_chunked(cfg: MfccConfig) -> np.ndarray:
    """(512, 400) float32: chunk c's rows 128 c .. 128 c + 63 are the
    cosine rows of bins 64 c .. 64 c + 63 of ``dft_matrices`` (window and
    preemphasis folded in), the next 64 their negated sine rows."""
    cos, sin = dft_matrices(feature_window(cfg), cfg.padded_window_size,
                            cfg.preemphasis_coefficient)
    assert not sin[0].any(), "the sine of bin 0 is not zero"
    rows = np.stack([cos[:BINS].reshape(-1, CHUNK, WINDOW),
                     -sin[:BINS].reshape(-1, CHUNK, WINDOW)], axis=1)
    return rows.reshape(2 * BINS, WINDOW)


def mel_tables(cfg: MfccConfig) -> dict:
    """The mel bank without its zero Nyquist column, as the kernel reads
    it: each filter's bins [mel_lo, mel_hi), and for each bin its first
    filter ``bin_lo`` and its weights ``bin_w`` (256, 2) in filters bin_lo
    and bin_lo + 1 (0 where there is none)."""
    banks = mel_banks(cfg)
    nmel = banks.shape[0]
    assert not banks[:, BINS:].any(), "the Nyquist mel column is not zero"
    melw = banks[:, :BINS]
    nz = melw != 0
    mel_lo = np.where(nz.any(1), nz.argmax(1), 0)
    mel_hi = np.where(nz.any(1), BINS - nz[:, ::-1].argmax(1), 0)
    bin_lo = np.zeros(BINS, np.int64)
    bin_w = np.zeros((BINS, 2), np.float32)
    for k in range(BINS):
        filt = np.flatnonzero(nz[:, k])
        assert len(filt) <= 2 and (len(filt) < 2 or filt[1] == filt[0] + 1), \
            f"bin {k} feeds filters {filt}"
        if len(filt):
            bin_lo[k] = filt[0]
            bin_w[k, :len(filt)] = melw[filt, k]
    assert all(nz[m, mel_lo[m]:mel_hi[m]].all() for m in range(nmel))
    return {"mel_lo": mel_lo, "mel_hi": mel_hi, "bin_lo": bin_lo,
            "bin_w": bin_w}


def _pad8(a: np.ndarray, cols: int) -> np.ndarray:
    """``a`` with zero columns up to the next multiple of 8 at or past
    ``cols``."""
    out = np.zeros((a.shape[0], -(-cols // 8) * 8), np.float32)
    out[:, :a.shape[1]] = a
    return out


@functools.lru_cache(maxsize=None)
def _consts(cfg: MfccConfig, device: torch.device) -> dict:
    """The kernel's constants on ``device``, built once per (config,
    device): the chunked DFT in float32 (the plain version rounds it to its
    ``dtype``), in bf16 and its bf16 transpose; the mel tables (int32
    indices for the kernel); the DCT, and for the kernel its transpose
    (forward) and itself (backward) zero-padded to 8 columns, the
    backward's past num_mel_bins; the lifter."""
    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()
    dft32 = dev(dft_chunked(cfg))
    dft = dft32.to(torch.bfloat16)
    t = mel_tables(cfg)
    dct = dct_matrix(cfg)
    lifter = (lifter_coeffs(cfg) if cfg.cepstral_lifter != 0.0
              else np.ones(cfg.num_ceps, np.float32))
    return {"dft32": dft32, "dft": dft, "dft_t": dft.T.contiguous(),
            "mel_lo": dev(t["mel_lo"], torch.int32),
            "mel_hi": dev(t["mel_hi"], torch.int32),
            "bin_lo": dev(t["bin_lo"], torch.int32),
            "bin_w": dev(t["bin_w"]), "dct": dev(dct),
            "dct_t8": dev(_pad8(dct.T, cfg.num_ceps)),
            "dct8": dev(_pad8(dct, cfg.num_mel_bins + 1)),
            "lifter": dev(lifter)}


# ---------------------------------------------------------------------------
# the plain mirror of the kernel's arithmetic
# ---------------------------------------------------------------------------

def _frames(wav, noise, cfg):
    """(f, energy): the frames after dither and DC removal (B, T, 400)
    and their energies sum f^2 (B, T), float32."""
    x = wav[:, _frame_index(wav.shape[1], cfg, wav.device)]
    if noise is not None:
        x = x + cfg.dither * noise
    f = x - x.mean(dim=-1, keepdim=True)
    return f, (f * f).sum(dim=-1)


def _round(x, dtype):
    """x rounded to ``dtype``, as float32."""
    return x.to(dtype).to(torch.float32)


def _spectra(f, dft, dtype):
    """(re, im) of bins 0-255, each (B, T, 256): the frames' product with
    the chunked DFT, operands in ``dtype``, float32 sums."""
    spec = (_round(f, dtype) @ _round(dft, dtype).T).unflatten(
        -1, (-1, 2, CHUNK))
    return spec[..., 0, :].flatten(-2), spec[..., 1, :].flatten(-2)


def mfcc_fwd_plain(wav, noise, cfg, dtype=None):
    """-> (features (B, T, num_ceps), mel (B, T, num_mel_bins)), float32:
    the kernel's forward, its DFT operands in ``dtype`` (None: the fast
    path's for the wave's device)."""
    c = _consts(cfg, wav.device)
    f, energy = _frames(wav, noise, cfg)
    re, im = _spectra(f, c["dft32"], dtype or fast_dot_dtype(wav.device))
    power = re * re + im * im
    # the mel as a sparse sum: each bin into its two filters
    mel = power.new_zeros(*power.shape[:-1], cfg.num_mel_bins + 1)
    mel.index_add_(-1, c["bin_lo"], power * c["bin_w"][:, 0])
    mel.index_add_(-1, c["bin_lo"] + 1, power * c["bin_w"][:, 1])
    mel = mel[..., :-1]
    feat = (torch.log(torch.clamp(mel, min=EPSILON)) @ c["dct"].T
            * c["lifter"])
    feat[..., 0] = torch.log(torch.clamp(energy, min=EPSILON))
    return feat, mel


def mfcc_bwd_plain(wav, noise, cfg, mel, cot, dtype=None):
    """-> the wave's gradient (B, L) float32 from the features' cotangent
    ``cot`` and the forward's ``mel``: the kernel's backward, the DFT
    recomputed and its operands in ``dtype`` (None: as the forward)."""
    c = _consts(cfg, wav.device)
    dtype = dtype or fast_dot_dtype(wav.device)
    f, energy = _frames(wav, noise, cfg)
    re, im = _spectra(f, c["dft32"], dtype)
    glm = (cot[..., 1:] * c["lifter"][1:]) @ c["dct"][1:]
    gm = torch.where(mel >= EPSILON, glm / torch.clamp(mel, min=EPSILON),
                     0.0)
    gm = torch.nn.functional.pad(gm, (0, 1))
    gp = (gm[..., c["bin_lo"]] * c["bin_w"][:, 0]
          + gm[..., c["bin_lo"] + 1] * c["bin_w"][:, 1])
    # [bf16(gP re), bf16(gP im)] in the chunks' order: one product, K = 512
    a = torch.stack([(gp * re).unflatten(-1, (-1, CHUNK)),
                     (gp * im).unflatten(-1, (-1, CHUNK))], dim=-2)
    diff = _round(a.flatten(-3), dtype) @ _round(c["dft32"], dtype)
    de = torch.where(energy >= EPSILON,
                     cot[..., 0] / torch.clamp(energy, min=EPSILON), 0.0)
    gf = 2.0 * diff + (2.0 * de)[..., None] * f
    gx = gf - gf.mean(dim=-1, keepdim=True)
    idx = _frame_index(wav.shape[1], cfg, wav.device).reshape(-1)
    return torch.zeros_like(wav).index_add_(1, idx,
                                            gx.reshape(wav.shape[0], -1))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# The argument types of csrc/mfcc.cu's C entry points, in order.
ARGTYPES = {
    # wav, noise, dither, b, len, t, nmel, nceps, dft, mel_lo, mel_hi,
    # bin_lo, bin_w, dct_t, dct_ld, lifter, feat, mel, stream
    "sg_mfcc_fwd": [PTR, PTR, FLT, INT, INT, INT, INT, INT, PTR, PTR, PTR,
                    PTR, PTR, PTR, INT, PTR, PTR, PTR, PTR],
    # wav, noise, dither, b, len, t, nmel, nceps, dft, dft_t, bin_lo,
    # bin_w, dct, dct_ld, lifter, mel, cot, gm, gld, gwav, stream
    "sg_mfcc_bwd": [PTR, PTR, FLT, INT, INT, INT, INT, INT, PTR, PTR, PTR,
                    PTR, PTR, INT, PTR, PTR, PTR, PTR, INT, PTR, PTR],
}
LIB = Library("mfcc", ARGTYPES)


def _operands(wav, noise, cfg):
    """(wav, noise, frames a wave) checked; the tensors contiguous, the
    noise 16-byte aligned (the kernels copy its rows in bulk)."""
    if wav.dim() != 2 or wav.dtype != torch.float32:
        raise ValueError(f"a (B, L) float32 wave expected, not "
                         f"{tuple(wav.shape)} {wav.dtype}")
    # raises for a wave too short to frame (an index mirrored twice)
    _frame_index(wav.shape[1], cfg, torch.device("cpu"))
    t = num_frames(wav.shape[1], cfg)
    if noise is not None:
        if tuple(noise.shape) != (wav.shape[0], t, WINDOW) or \
                noise.dtype != torch.float32 or noise.device != wav.device:
            raise ValueError(f"dither noise of shape "
                             f"{(wav.shape[0], t, WINDOW)} float32 on "
                             f"{wav.device} expected")
        noise = noise.contiguous()
        if noise.data_ptr() % 16:
            noise = noise.clone()
    return wav.contiguous(), noise, t


class _MfccFwd(KernelWrapper):
    """``mfcc_fwd(wav, noise, cfg) -> (features, mel)``."""

    name = "mfcc_fwd"
    lib = LIB

    def __call__(self, wav, noise, cfg):
        check_config(cfg)
        wav, noise, t = _operands(wav, noise, cfg)
        if not self.route(wav):
            return mfcc_fwd_plain(wav, noise, cfg)
        c = _consts(cfg, wav.device)
        b = wav.shape[0]
        feat = torch.empty(b, t, cfg.num_ceps, device=wav.device)
        mel = torch.empty(b, t, cfg.num_mel_bins, device=wav.device)
        self._launch("sg_mfcc_fwd", wav.device, wav, noise, cfg.dither, b,
                     wav.shape[1], t, cfg.num_mel_bins, cfg.num_ceps,
                     c["dft"], c["mel_lo"], c["mel_hi"], c["bin_lo"],
                     c["bin_w"], c["dct_t8"], c["dct_t8"].shape[1],
                     c["lifter"], feat, mel)
        return feat, mel


class _MfccBwd(KernelWrapper):
    """``mfcc_bwd(wav, noise, cfg, mel, cot) -> the wave's gradient``."""

    name = "mfcc_bwd"
    lib = LIB

    def __call__(self, wav, noise, cfg, mel, cot):
        check_config(cfg)
        wav, noise, t = _operands(wav, noise, cfg)
        shape = (wav.shape[0], t)
        if tuple(mel.shape) != shape + (cfg.num_mel_bins,) or \
                tuple(cot.shape) != shape + (cfg.num_ceps,):
            raise ValueError(f"mel {tuple(mel.shape)} and cotangent "
                             f"{tuple(cot.shape)} do not fit {shape}")
        mel = mel.contiguous()
        cot = cot.to(torch.float32).contiguous()
        if not self.route(wav):
            return mfcc_bwd_plain(wav, noise, cfg, mel, cot)
        c = _consts(cfg, wav.device)
        gld = (cfg.num_mel_bins + 4) // 4 * 4   # gM's row: past nmel, by 4
        gm = torch.empty(shape + (gld,), device=wav.device)
        gwav = torch.empty_like(wav)
        self._launch("sg_mfcc_bwd", wav.device, wav, noise, cfg.dither,
                     wav.shape[0], wav.shape[1], t, cfg.num_mel_bins,
                     cfg.num_ceps, c["dft"], c["dft_t"], c["bin_lo"],
                     c["bin_w"], c["dct8"], c["dct8"].shape[1], c["lifter"],
                     mel, cot, gm, gld, gwav)
        return gwav


mfcc_fwd = _MfccFwd()
mfcc_bwd = _MfccBwd()


class _MfccFast(torch.autograd.Function):
    """(wav, noise, cfg) -> features, through ``mfcc_fwd`` and
    ``mfcc_bwd``; the forward keeps the wave, the noise and the mel."""

    @staticmethod
    def forward(ctx, wav, noise, cfg):
        feat, mel = mfcc_fwd(wav, noise, cfg)
        ctx.save_for_backward(wav, noise, mel)
        ctx.cfg = cfg
        return feat

    @staticmethod
    def backward(ctx, cot):
        wav, noise, mel = ctx.saved_tensors
        return mfcc_bwd(wav, noise, ctx.cfg, mel, cot), None, None


def mfcc(wav: torch.Tensor, cfg: MfccConfig, noise=None) -> torch.Tensor:
    """The fast path's MFCC of (B, L) waves: (B, T, num_ceps) float32.
    ``noise``: the dither's standard normal (B, T, 400) draw, or None."""
    check_config(cfg)
    return _MfccFast.apply(wav.to(torch.float32), noise, cfg)
