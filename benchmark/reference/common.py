"""What every plain reference shares: the precision it computes in."""

import contextlib

import torch

# the precisions a reference runs in: "float32" is the reference itself;
# "tf32" is the control, the step below float32 with TF32 off
PRECISIONS = ("float32", "tf32")


@contextlib.contextmanager
def precision(name: str):
    """float32 with TF32 off for cuBLAS and cuDNN, or ("tf32") on; the
    previous settings come back on exit."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} not in {PRECISIONS}")
    on = name == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
