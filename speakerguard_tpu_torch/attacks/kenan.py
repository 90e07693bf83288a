"""Kenansville — the decision-only signal-processing attack.

Port of speakerguard_tpu/attacks/kenan.py (reference attack/Kenan.py,
_kenan_fft.py, _kenan.py): a binary search per wave over how much of the
signal to keep.

  * ``fft``: zero the rFFT bins whose magnitude is below a per-wave
    factor; the factor starts at half the largest magnitude of the full
    FFT and halves towards the last hit or miss.  Each of the ``max_iter``
    steps is one batched compression and one ``make_decision``.
  * ``ssa``: reconstruct each wave from its leading SSA components.  The
    waves are sniffed and truncated to int16 one by one, and the search
    runs on the host in float64, per lane, with early-stopped lanes frozen
    (the JAX package's code, unchanged).  Each step is one batched
    reconstruction on the device (``ops/ssa.py``: one batched SVD before
    the search, a masked product per step) and one decision.
    ``ssa_device=False`` is the JAX package's ``SG_SSA_DEVICE=0``: the
    float64 numpy oracle reconstructs on the host around the same search.

The model's dither comes from the attack's ``torch.Generator``; the JAX
package folds the step into its key instead.
"""

import numpy as np
import torch

from speakerguard_tpu_torch.attacks.base import (Attack, make_generator,
                                                 normalize_wav_input)
from speakerguard_tpu_torch.ops.ssa import (inv_ssa, inv_ssa_masked, ssa,
                                            ssa_device)
from speakerguard_tpu_torch.utils.ranges import ABS_MAX


def fft_compression(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Zero the rFFT bins with |X_k| < factor (per wave).  x: (B, L)."""
    spec = torch.fft.rfft(x, dim=-1)
    keep = torch.abs(spec) >= factor[:, None]
    return torch.fft.irfft(torch.where(keep, spec, torch.zeros_like(spec)),
                           n=x.shape[-1], dim=-1)


class Kenan(Attack):

    def __init__(self, model, atk_name="fft", max_iter=15, raster_width=100,
                 early_stop=False, targeted=False, ssa_device=True):
        # ssa_device: the device SVD and reconstruction (True) or the
        # float64 host oracle (False).  The JAX class's verbose, BITS and
        # batch_size do nothing there and are not taken: the whole batch
        # runs at once.
        self.model = model
        self.atk_name = atk_name
        self.max_iter = max_iter
        self.raster_width = raster_width
        self.targeted = targeted
        self.early_stop = early_stop
        self.ssa_device = ssa_device
        # the steps the last ssa attack ran (fewer than max_iter when
        # every lane froze)
        self.last_executed_steps = None

    def _hit(self, decisions, y):
        return (decisions == y) if self.targeted else (decisions != y)

    # ------------------------------------------------------------------
    def _attack_fft(self, x, y, gen):
        with torch.no_grad():
            max_f = torch.max(torch.abs(torch.fft.fft(x, dim=-1)), dim=-1
                              ).values
            min_f = torch.zeros_like(max_f)
            factor = max_f / 2.0
            best_x = x
            succ = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
            for _ in range(self.max_iter):
                perturbed = fft_compression(x, factor)
                decisions, _ = self.model.make_decision(perturbed, rng=gen)
                hit = self._hit(decisions, y)
                best_x = torch.where(hit[:, None], perturbed, best_x)
                succ = succ | hit
                max_f = torch.where(hit, factor, max_f)
                min_f = torch.where(hit, min_f, factor)
                factor = torch.abs(min_f + max_f) / 2.0
        self.last_executed_steps = self.max_iter
        return best_x, succ.tolist()

    # ------------------------------------------------------------------
    def _attack_ssa(self, x, y, gen):
        """The batched search: the state (min, max, val per lane) lives on
        the host in float64, the arithmetic the per-wave Python loop of the
        reference performs, so a batch equals its waves one at a time for a
        deterministic model.  A lane whose keep count stops changing
        freezes under early stop: its state and best reconstruction never
        change again."""
        b, n = x.shape
        dev = x.device
        wav = x.detach().cpu().numpy().astype(np.float64)
        # per-wave scale sniff (reference _kenan.py:188-193)
        in_unit = ((0.9 * wav.max(axis=1) <= 1)
                   & (0.9 * wav.min(axis=1) >= -1))
        wav_i = np.where(in_unit[:, None], wav * ABS_MAX, wav)
        wav_i = wav_i.astype(np.int16).astype(np.float64)
        window = min(int(n * 0.05), 3000)
        if self.ssa_device:
            with torch.no_grad():
                pc, _, v = ssa_device(torch.tensor(wav_i, dtype=torch.float32,
                                                   device=dev), window)
        else:
            host = [ssa(wav_i[i], window) for i in range(b)]
            pc_h = [h[0] for h in host]
            v_h = [h[2] for h in host]

        def keep_of(vals):
            return np.maximum((window * vals / 100.0).astype(np.int64), 1)

        min_a = np.zeros(b)
        max_a = np.full(b, float(self.raster_width))
        val = np.full(b, float(self.raster_width) / 2)
        best = wav_i.copy()
        succ = np.zeros(b, bool)
        frozen = np.zeros(b, bool)
        label = y.cpu().numpy()
        steps = 0
        for _ in range(self.max_iter):
            if frozen.all():
                break
            keep = keep_of(val)
            with torch.no_grad():
                if self.ssa_device:
                    rec_t = inv_ssa_masked(pc, v, torch.tensor(keep,
                                                               device=dev))
                    d, _ = self.model.make_decision(rec_t / ABS_MAX, rng=gen)
                    rec = rec_t.cpu().numpy().astype(np.float64)
                else:
                    rec = np.stack([inv_ssa(pc_h[i], v_h[i],
                                            np.arange(keep[i]))
                                    for i in range(b)])
                    d, _ = self.model.make_decision(torch.tensor(
                        (rec / ABS_MAX).astype(np.float32), device=dev),
                        rng=gen)
            pred = d.cpu().numpy()
            steps += 1
            hit = (pred == label) if self.targeted else (pred != label)
            live = ~frozen
            upd = hit & live
            best[upd] = rec[upd]
            succ |= upd
            # success -> keep fewer components (reference direction)
            min_a = np.where(upd, val, min_a)
            max_a = np.where(live & ~hit, val, max_a)
            new_val = np.abs(min_a + max_a) / 2
            if self.early_stop:
                frozen |= live & (keep_of(new_val) == keep)
            val = np.where(frozen, val, new_val)
        self.last_executed_steps = steps
        adver = torch.tensor((best / ABS_MAX).astype(np.float32), device=dev)
        return adver, [bool(s) for s in succ]

    # ------------------------------------------------------------------
    def attack(self, x, y, rng=None, fs=16000):
        """x: (B, L) | (B, 1, L) | (L,) scale-domain audio; y: (B,) labels;
        rng: torch.Generator, int seed or None (the model's dither).
        Returns (adversarial audio shaped like x, per-wave success
        list)."""
        dev = self.model.device
        x, restore = normalize_wav_input(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        gen = make_generator(rng, dev)
        if self.atk_name == "fft":
            adver, succ = self._attack_fft(x, y, gen)
        elif self.atk_name == "ssa":
            adver, succ = self._attack_ssa(x, y, gen)
        else:
            raise NotImplementedError(self.atk_name)
        return restore(adver), succ
