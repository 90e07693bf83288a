"""IMA ADPCM encode + decode round-trip: the CUDA kernel and its plain version.

The JAX package runs this codec as a ``lax.scan`` over time
(speakerguard_tpu/defenses/speech_compression.py ``_adpcm_nondiff``), which
XLA compiles to one device loop; it is no Pallas kernel.  The step is a
serial recurrence over the samples of a wave, on a few scalars of state
(the predictor and the step index), so eager PyTorch would pay ~20 small
launches a sample.  ``csrc/adpcm.cu`` runs the recurrence instead, one
lane of a warp a wave; a second warp of the block stages the waves through
shared memory with coalesced copies, so no global load or store sits on
the chain.  Its coder is the closed form of the bit-serial taps where that
is exact and cheaper (bits <= ``CLOSED_FORM_MAX_BITS``: the code is the
count of the thresholds k*u that the remainder reaches), and the next step
and index are selected by the code from five candidates read ahead, each
lane reading its own copy of the step table.

``adpcm(x16, bits)`` takes (B, L) float32 samples already clipped to the
int16 range and returns the decoded (B, L) float32 samples, the
predictor after each step.  ``adpcm.scaled(wav, bits)`` is the ADPCM
defense's whole round trip on audio in either domain: the batch-wide
domain sniff (one ``torch.aminmax``, read by the kernel on the device),
then one launch that scales and clamps on load and scales back on store
(``adpcm_scaled_plain`` is the same in torch).  On a CUDA tensor each
launches the kernel; on a CPU tensor each runs its plain version.  Both
run the JAX body's float32 operations in its order, so the kernel equals
the plain version bit for bit: every product in the step is exact, and the
kernel writes each add with ``__fadd_rn`` so that nvcc cannot contract it
into a fused multiply-add.
"""

import numpy as np
import torch

from speakerguard_tpu_torch.ops._build import (INT, PTR, KernelWrapper,
                                               Library)
from speakerguard_tpu_torch.utils.ranges import ABS_MAX

# IMA ADPCM step-size table (DVI ADPCM specification); csrc/adpcm.cu holds
# the same table and the index adjustments, and LIB checks its length
IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.float32)
IMA_INDEX_ADJ = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.float32)
# csrc/adpcm.cu's kClosedMaxBits: it codes bits 2..4 in closed form and taps
# the other bits serially (a CPU test holds the two to each other)
CLOSED_FORM_MAX_BITS = 4


def _check(x16: torch.Tensor, bits: int):
    if x16.ndim != 2:
        raise ValueError(f"expected (B, L), got {tuple(x16.shape)}")
    if x16.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x16.dtype}")
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")


def adpcm_plain(x16: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """The round-trip as a torch loop over time on (B,) state, the JAX
    body's operations in its order: the bit-serial coder over ``bits - 1``
    taps (recon accumulates the decoder's vpdiff), then ``recon + s``, the
    sign, the clipped predictor and the index update through
    ``IMA_INDEX_ADJ[min(code, 7)]``."""
    _check(x16, bits)
    dev = x16.device
    steps = torch.as_tensor(IMA_STEPS, device=dev)
    adj = torch.as_tensor(IMA_INDEX_ADJ, device=dev)
    b, n = x16.shape
    mag_max = float(2 ** (bits - 1) - 1)
    pred = torch.zeros(b, device=dev)
    idx = torch.zeros(b, device=dev)
    out = torch.empty_like(x16)
    for t in range(n):
        step = steps[idx.long()]
        diff = x16[:, t] - pred
        sign = diff < 0
        rem = torch.abs(diff)
        code = torch.zeros_like(rem)
        recon = torch.zeros_like(rem)
        s = step
        for _ in range(bits - 1):
            bit = rem >= s
            code = code * 2 + bit
            rem = torch.where(bit, rem - s, rem)
            recon = recon + bit * s
            s = s / 2.0
        code = torch.clamp(code, max=mag_max)
        recon = recon + s
        recon = torch.where(sign, -recon, recon)
        pred = torch.clamp(pred + recon, -ABS_MAX, ABS_MAX - 1.0)
        idx = torch.clamp(idx + adj[torch.clamp(code, max=7.0).long()], 0,
                          len(IMA_STEPS) - 1)
        out[:, t] = pred
    return out


def adpcm_scaled_plain(wav: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """The ADPCM defense's round trip (``defenses/speech_compression.py``
    ``_adpcm_nondiff`` on a (B, L) batch) in torch: the batch-wide domain
    sniff, ``* factor``, ``* ABS_MAX`` and the int16 clamp, ``adpcm_plain``,
    then ``/ ABS_MAX`` and ``* restore``."""
    _check(wav, bits)
    lo, hi = torch.aminmax(wav)
    big = torch.logical_or(hi > 2.0, lo < -2.0)
    factor = torch.where(big, wav.new_tensor(1.0 / ABS_MAX),
                         wav.new_tensor(1.0))
    restore = torch.where(big, wav.new_tensor(ABS_MAX), wav.new_tensor(1.0))
    x16 = torch.clamp(wav * factor * ABS_MAX, -ABS_MAX, ABS_MAX - 1.0)
    return adpcm_plain(x16, bits) / ABS_MAX * restore


# The argument types of csrc/adpcm.cu's C entry points, in order.
ARGTYPES = {
    # x16, out, batch, length, bits, stream
    "sg_adpcm": [PTR, PTR, INT, INT, INT, PTR],
    # wav, out, wav_min, wav_max, batch, length, bits, stream
    "sg_adpcm_scaled": [PTR, PTR, PTR, PTR, INT, INT, INT, PTR],
    "sg_adpcm_n_steps": [],
}
LIB = Library("adpcm", ARGTYPES, {"sg_adpcm_n_steps": len(IMA_STEPS)})


class _Adpcm(KernelWrapper):
    """``adpcm(x16, bits=4) -> decoded`` and ``adpcm.scaled(wav, bits=4)``,
    counting their calls."""

    name = "adpcm"
    lib = LIB

    def __call__(self, x16: torch.Tensor, bits: int = 4) -> torch.Tensor:
        _check(x16, bits)
        if not self.route(x16):
            return adpcm_plain(x16, bits)
        x16 = x16.contiguous()
        out = torch.empty_like(x16)
        self._launch("sg_adpcm", x16.device, x16, out, *x16.shape, int(bits))
        return out

    def scaled(self, wav: torch.Tensor, bits: int = 4) -> torch.Tensor:
        """The ADPCM defense on (B, L) audio in either domain: one
        ``torch.aminmax`` and one launch on a CUDA tensor, no host sync;
        ``adpcm_scaled_plain`` on a CPU one."""
        _check(wav, bits)
        if not self.route(wav):
            return adpcm_scaled_plain(wav, bits)
        wav = wav.contiguous()
        lo, hi = torch.aminmax(wav)
        out = torch.empty_like(wav)
        self._launch("sg_adpcm_scaled", wav.device, wav, out, lo, hi,
                     *wav.shape, int(bits))
        return out


adpcm = _Adpcm()
