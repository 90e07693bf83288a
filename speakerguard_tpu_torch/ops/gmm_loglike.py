"""GMM component log-likelihood gconsts + aug(x) . quad_proj: CUDA kernel +
plain version.

Port of the Pallas TPU kernel speakerguard_tpu/ops/pallas_gmm.py
``fused_loglike`` / ``fused_loglike_batch``.  aug(x) = [x, packed(x x^T)]
takes the upper triangle in ``np.triu_indices`` order.  ``fused_loglike(x,
quad_proj, gconsts)`` launches kernel A of ``csrc/gmm.cu`` on CUDA tensors,
which builds the augmented columns of each tile in shared memory and never
writes the (B, T, D + D(D+1)/2) tensor, and runs ``fused_loglike_plain`` on
CPU tensors.  Both are float32 throughout: the kernel lies on the exact
scoring path.  One launch covers the whole (B, T) batch.
"""

import ctypes
import functools

import numpy as np
import torch

from speakerguard_tpu_torch.ops._build import (KernelWrapper, check_rc,
                                               load_library)


def aug_dim(d: int) -> int:
    return d + d * (d + 1) // 2


@functools.lru_cache(maxsize=None)
def packed_indices(d: int, device: torch.device):
    """np.triu_indices(d) (row <= col) as long tensors on the device."""
    return tuple(torch.as_tensor(i, device=device) for i in np.triu_indices(d))


@functools.lru_cache(maxsize=None)
def pair_table(d: int, device: torch.device) -> torch.Tensor:
    """The kernels' (D(D+1)/2,) int32 table: packed index p -> r | c << 16
    with (r, c) = np.triu_indices(d)[:, p]."""
    rows, cols = np.triu_indices(d)
    return torch.as_tensor((rows | (cols << 16)).astype(np.int32),
                           device=device)


def augment_plain(x: torch.Tensor) -> torch.Tensor:
    """aug(x) = [x, x[..., rows] * x[..., cols]]: (..., D) -> (..., F)."""
    rows, cols = packed_indices(x.shape[-1], x.device)
    return torch.cat([x, x[..., rows] * x[..., cols]], dim=-1)


def fused_loglike_plain(x: torch.Tensor, quad_proj: torch.Tensor,
                        gconsts: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch ops: (..., T, D) -> (..., T, C)."""
    return augment_plain(x) @ quad_proj + gconsts


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/gmm.cu, built at first use, with its C entry point declared."""
    lib = load_library("gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sg_fused_loglike.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.sg_fused_loglike.restype = ctypes.c_int
    return lib


def check_operands(x: torch.Tensor, proj: torch.Tensor,
                   gconsts: torch.Tensor, proj_dtype: torch.dtype):
    """x (..., D) f32, proj (D + D(D+1)/2, C) of ``proj_dtype``, gconsts
    (C,) f32, all on one device."""
    if x.dtype != torch.float32 or gconsts.dtype != torch.float32:
        raise TypeError(f"expected float32 x and gconsts, got {x.dtype}, "
                        f"{gconsts.dtype}")
    if proj.dtype != proj_dtype:
        raise TypeError(f"expected a {proj_dtype} projection, got "
                        f"{proj.dtype}")
    d = x.shape[-1]
    if proj.ndim != 2 or proj.shape[0] != aug_dim(d) or gconsts.shape != (
            proj.shape[1],):
        raise ValueError(f"x (..., {d}) needs a ({aug_dim(d)}, C) projection "
                         f"and (C,) gconsts, got {tuple(proj.shape)} and "
                         f"{tuple(gconsts.shape)}")
    if not (x.device == proj.device == gconsts.device):
        raise ValueError("x, the projection and gconsts must share a device")


class _FusedLoglike(KernelWrapper):
    """``fused_loglike(x, quad_proj, gconsts) -> loglike`` for x (..., T, D)
    float32, quad_proj (D + D(D+1)/2, C) float32, gconsts (C,)."""

    name = "fused_loglike"

    def __call__(self, x: torch.Tensor, quad_proj: torch.Tensor,
                 gconsts: torch.Tensor) -> torch.Tensor:
        check_operands(x, quad_proj, gconsts, torch.float32)
        if not self.route(x):
            return fused_loglike_plain(x, quad_proj, gconsts)
        d = x.shape[-1]
        c = quad_proj.shape[1]
        # held in locals until the launch: a freed temporary's memory could
        # be handed to the next allocation before the kernel reads it
        xc, pc, gc = (t.contiguous() for t in (x, quad_proj, gconsts))
        pairs = pair_table(d, x.device)
        out = torch.empty((*x.shape[:-1], c), dtype=torch.float32,
                          device=x.device)
        lib = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.sg_fused_loglike(
                xc.data_ptr(), pc.data_ptr(), gc.data_ptr(),
                pairs.data_ptr(), out.data_ptr(), xc.numel() // d, d, c,
                stream)
        check_rc(rc, self.name)
        self.launches += 1
        return out


fused_loglike = _FusedLoglike()
