"""The fast path's matmul precision: bf16 operands with float32
accumulation on the card, float32 on the CPU.

Port of speakerguard_tpu/models/gmm.py ``fast_dot_dtype`` and of its
``preferred_element_type=float32`` dots.  Every fast-path product of the
frontend and the models takes its operand dtype from ``fast_dot_dtype`` and
multiplies through ``dot_f32``.
"""

import torch


def fast_dot_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card; float32 on the CPU.  The JAX package has bf16 on
    the TPU and float32 elsewhere (speakerguard_tpu/models/gmm.py
    fast_dot_dtype): off the
    accelerator the operands are still the bf16-ROUNDED weight copies, so
    the CPU tests see the same weight rounding as JAX's CPU run."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if b.ndim == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.bmm(a, b, out_dtype=torch.float32)


class _DotF32(torch.autograd.Function):
    """The bf16 product of ``dot_f32`` under autograd (the out_dtype GEMM
    has no derivative of its own): each input's cotangent is the same kind
    of product, the f32 cotangent rounded to bf16, rounded to the input's
    dtype as JAX's transpose of a preferred_element_type dot does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_f32(g, b.mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.ndim == 2:
                gb = _mm_f32(a.reshape(-1, a.shape[-1]).T,
                             g.reshape(-1, g.shape[-1]))
            else:
                gb = _mm_f32(a.mT, g)
            gb = gb.to(b.dtype)
        return ga, gb


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation and a float32 result (JAX's
    ``preferred_element_type=float32``).  bf16 operands go to a bf16 GEMM
    with an f32 output (``out_dtype``); a (..., M, K) @ (K, N) product is
    flattened to one GEMM, (B, M, K) @ (B, K, N) is a batched one."""
    if a.dtype != torch.bfloat16:
        return a @ b
    return _DotF32.apply(a, b)
