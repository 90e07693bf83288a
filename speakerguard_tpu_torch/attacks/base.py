"""Attack base: the uniform attack(x, y) -> (adver_x, success) contract
(reference attack/Attack.py) plus shared helpers.

Port of speakerguard_tpu/attacks/base.py.  Attacks operate on waveforms in
the *scale* domain ([-1, 1)) with shape (B, L) (the reference's (B, 1, T) is
accepted and squeezed), on the device of the model they attack.
"""

import warnings

import torch

from speakerguard_tpu_torch.attacks.losses import compare


def make_generator(rng, device) -> torch.Generator:
    """``rng``: a torch.Generator (used as is), an int seed, or None
    (seed 0).  The generator draws the attack's init noise and dither."""
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if rng is None else int(rng))
    return gen


class Attack:
    targeted: bool = False
    batch_size: int = 1

    def attack(self, x, y, rng=None):
        raise NotImplementedError

    def compare(self, y, y_pred, targeted):
        return compare(y, y_pred, targeted).tolist()

    def run_batched(self, attack_batch_fn, x, y, rng, batch_size=None):
        """Split the input into batch_size chunks like the reference's
        attack() loops (FGSM.py:83-96); ``rng`` (a torch.Generator) advances
        through the chunks in order."""
        n = x.shape[0]
        bs = min(batch_size or getattr(self, "batch_size", n) or n, n)
        if bs >= n:
            return attack_batch_fn(x, y, rng)
        advers, successes = [], []
        for s in range(0, n, bs):
            a, su = attack_batch_fn(x[s:s + bs], y[s:s + bs], rng)
            advers.append(a)
            successes += list(su)
        return torch.cat(advers, dim=0), successes


def normalize_wav_input(x, device=None):
    """(B, 1, L) | (B, L) | (L,) -> ((B, L) float32 tensor, restore_fn).

    Also a domain gate: every attack entry point funnels through here, so
    origin-domain (int16-valued float) audio is rejected loudly instead of
    silently attacking a 32768x mis-scaled signal."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    assert_scale_domain(x)
    shape = x.shape
    if x.ndim == 1:
        flat = x[None, :]
    elif x.ndim == 3:
        if x.shape[1] != 1:
            raise ValueError("only mono audio")
        flat = x[:, 0, :]
    else:
        flat = x
    return flat, lambda y: torch.reshape(y, shape)


def assert_scale_domain(x: torch.Tensor, what="attack input"):
    """Raise if an array is clearly not scale-domain audio (|x| >> 1), warn
    if it is implausibly quiet (scale-domain audio divided by 2**15 again).
    Attacks operate in [-1, 1) (reference attackMain.py:188-189)."""
    m = float(torch.max(torch.abs(x))) if x.numel() else 0.0
    if m > 2.0:
        raise ValueError(
            f"{what} has max|x|={m:.1f}; expected scale-domain audio in "
            "[-1, 1). Origin-domain (int16-valued float) audio must be "
            "divided by 2**15 exactly once before attacking; "
            "Dataset(normalize=True) already yields the scale domain.")
    if x.numel() and 0.0 < m < 1e-3:
        warnings.warn(
            f"{what} has max|x|={m:.2e}; implausibly small for audio — "
            "was scale-domain input divided by 2**15 a second time? "
            "Dataset(normalize=True) already yields the scale domain.",
            stacklevel=2)
