"""Input-range ("domain") conventions.

Waveforms travel in one of two float domains (reference model/utils.py:7-19):

  * ``scale``  — floats in [-1, 1)            (what attacks operate in)
  * ``origin`` — int16-valued floats in [-2^15, 2^15)  (what Kaldi models eat)

``check_input_range(x, range_type)`` converts between them with the
reference's 0.9-margin heuristic: an array is in the ``scale`` domain iff
``0.9*max(x) <= 1 and 0.9*min(x) >= -1``.  The rule is applied branch-free
(one multiplicative factor chosen by ``torch.where``), as in the JAX package,
so the decision never syncs the device with the host.
"""

import torch

BITS = 16
ABS_MAX = float(2 ** (BITS - 1))  # 32768.0


def check_input_range(x: torch.Tensor, range_type: str = "scale",
                      bits: int = BITS) -> torch.Tensor:
    """Convert ``x`` to the requested domain (branch-free)."""
    if range_type not in ("scale", "origin"):
        raise ValueError(f"range_type must be 'scale' or 'origin', "
                         f"got {range_type!r}")
    abs_max = float(2 ** (bits - 1))
    is_scale = torch.logical_and(0.9 * torch.max(x) <= 1.0,
                                 0.9 * torch.min(x) >= -1.0)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    if range_type == "origin":
        factor = torch.where(is_scale, one * abs_max, one)
    else:
        factor = torch.where(is_scale, one, one / abs_max)
    return x * factor

