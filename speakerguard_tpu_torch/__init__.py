"""speakerguard_tpu_torch — the PyTorch/CUDA port of speakerguard_tpu.

The JAX package ``speakerguard_tpu`` stays the reference; this package mirrors
its module paths and names so each counterpart is easy to find, and imports
nothing from it (numpy-only helpers it needs are copied here).

Device: entry points build their tensors on ``cuda`` unless the caller passes
``device="cpu"`` (the CPU tests do).  Hand-written kernels run only on CUDA
tensors; on CPU tensors each wrapper runs its plain PyTorch version.

Precision: the exact JAX path is float32 throughout.  TF32 would silently
lower float32 matmuls and convolutions on the card to ~10 mantissa bits, so
importing this package turns it off for both cuBLAS and cuDNN.  The fast
attack-gradient path multiplies bf16 operands; JAX's
``preferred_element_type=float32`` accumulates those products in float32,
while cuBLAS may by default reduce a bf16 GEMM in reduced precision, so
importing this package also turns that off
(``allow_bf16_reduced_precision_reduction``).
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``cuda`` unless told otherwise."""
    return torch.device("cuda" if device is None else device)
