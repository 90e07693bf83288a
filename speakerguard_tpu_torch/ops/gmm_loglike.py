"""GMM component log-likelihood gconsts + aug(x) . quad_proj: CUDA kernel +
plain versions.

Port of the Pallas TPU kernel speakerguard_tpu/ops/pallas_gmm.py
``fused_loglike`` / ``fused_loglike_batch``.  aug(x) = [x, packed(x x^T)]
takes the upper triangle in ``np.triu_indices`` order.  The function is
float32 (it lies on the exact scoring path); ``fused_loglike_plain`` is its
plain version, which CPU tensors take.

On CUDA tensors ``fused_loglike(x, quad_proj, gconsts)`` computes the f32
product as six bf16 products on the tensor cores, as the TPU's
Precision.HIGHEST does: each f32 value v is split into three bf16 pieces
(``split3_plain``: a1 = bf16(v), a2 = bf16(v - a1), a3 = bf16(v - a1 -
a2)), and the product sums the terms a_i b_j with i + j <= 4.  Its steps,
each with a plain version that the card's checks compare it with:

  1. ``aug_split``: the split aug(x) of the N = B T flattened rows, written
     once as augS (N, 3 F_pad) bf16 = [a1 | a2 | a3], F_pad =
     ``padded_k(F)`` (``augment_split_plain``; launch 1 of ``csrc/gmm.cu``);
  2. ``proj_split_kmajor``: projS (C, 3 F_pad), the same split of
     quad_proj, K-major, in plain torch;
  3. ``loglike_split_gemm``: the six products on the TMA + wgmma GEMM,
     smallest first, plus gconsts (``loglike_split_plain``; launch 2).

The launch helpers take CUDA tensors only and raise on anything else.
"""

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

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


K_TILE = 64  # a piece's columns are padded to this (one TMA box row)
# (A piece, B piece) of the six products, in the GEMM's order: smallest
# first, so the small terms are summed before the large ones
SPLIT_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def padded_k(f: int) -> int:
    """F rounded up to whole 64-column K tiles."""
    return -(-f // K_TILE) * K_TILE


def split3_plain(v: torch.Tensor):
    """f32 v -> its bf16 pieces (a1, a2, a3), a1 = bf16(v), a2 = bf16(v -
    a1), a3 = bf16(v - a1 - a2), the differences exact in f32: together
    they carry v's 24-bit significand."""
    a1 = v.to(torch.bfloat16)
    r = v - a1.to(torch.float32)
    a2 = r.to(torch.bfloat16)
    return a1, a2, (r - a2.to(torch.float32)).to(torch.bfloat16)


def _split_padded(m: torch.Tensor) -> torch.Tensor:
    """(R, F) f32 -> (R, 3 F_pad) bf16: [a1 | a2 | a3] of m, each piece
    with zero pad columns (the split of 0)."""
    m = F.pad(m, (0, padded_k(m.shape[1]) - m.shape[1]))
    return torch.stack(split3_plain(m), dim=1).reshape(m.shape[0], -1)


def augment_split_plain(x: torch.Tensor) -> torch.Tensor:
    """x (..., D) f32 -> augS (N, 3 F_pad) bf16 over the flattened rows:
    the split of ``augment_plain(x)``."""
    return _split_padded(augment_plain(x.reshape(-1, x.shape[-1])))


def proj_split_kmajor(quad_proj: torch.Tensor) -> torch.Tensor:
    """quad_proj (F, C) f32 -> projS (C, 3 F_pad) bf16, the split of
    quad_proj^T: the split GEMM's K-major B operand, rows 128-byte
    aligned for TMA."""
    return _split_padded(quad_proj.T)


def loglike_split_plain(aug_s: torch.Tensor, proj_s: torch.Tensor,
                        gconsts: torch.Tensor) -> torch.Tensor:
    """augS (N, 3 F_pad), projS (C, 3 F_pad) bf16, gconsts (C,) f32 ->
    loglike (N, C) f32: the six products of SPLIT_PAIRS summed in that
    order (each a_i b_j exact in f32), then gconsts."""
    a = aug_s.to(torch.float32).reshape(aug_s.shape[0], 3, -1)
    b = proj_s.to(torch.float32).reshape(proj_s.shape[0], 3, -1)
    out = a.new_zeros((a.shape[0], b.shape[0]))
    for i, j in SPLIT_PAIRS:
        out += a[:, i] @ b[:, j].T
    return out + gconsts


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/gmm.cu, built at first use, with its two C entry points (one
    per launch) declared."""
    lib = load_library("gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sg_loglike_aug_split.argtypes = [p, p, p, i, i, i, p]
    lib.sg_loglike_split_gemm.argtypes = [p, p, p, p, i, i, i, p]
    for fn in (lib.sg_loglike_aug_split, lib.sg_loglike_split_gemm):
        fn.restype = ctypes.c_int
    return lib


def _require_cuda(what: str, *tensors: torch.Tensor):
    if not all(t.device.type == "cuda" for t in tensors):
        raise ValueError(f"{what} launches a CUDA kernel: its operands must "
                         f"lie on a CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def aug_split(x: torch.Tensor) -> torch.Tensor:
    """Launch 1 of ``fused_loglike``: ``augment_split_plain``'s function
    for x (..., D) float32 on the card."""
    if x.dtype != torch.float32 or x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"aug_split: expected a non-empty float32 x (..., "
                         f"D), got {tuple(x.shape)} {x.dtype}")
    _require_cuda("aug_split", x)
    d = x.shape[-1]
    xc = x.contiguous()
    rows = xc.numel() // d
    pairs = pair_table(d, x.device)
    f_pad = padded_k(aug_dim(d))
    aug_s = torch.empty((rows, 3 * f_pad), dtype=torch.bfloat16,
                        device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().sg_loglike_aug_split(
            xc.data_ptr(), pairs.data_ptr(), aug_s.data_ptr(), rows, d,
            f_pad, torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "fused_loglike (aug split)")
    return aug_s


def loglike_split_gemm(aug_s: torch.Tensor, proj_s: torch.Tensor,
                       gconsts: torch.Tensor) -> torch.Tensor:
    """Launch 2 of ``fused_loglike``: ``loglike_split_plain``'s function
    on the card."""
    if (aug_s.ndim != 2 or proj_s.ndim != 2
            or aug_s.shape[1] != proj_s.shape[1]
            or aug_s.shape[1] % (3 * K_TILE)
            or gconsts.shape != (proj_s.shape[0],)
            or aug_s.dtype != torch.bfloat16
            or proj_s.dtype != torch.bfloat16
            or gconsts.dtype != torch.float32
            or not (aug_s.is_contiguous() and proj_s.is_contiguous())):
        raise ValueError(f"loglike_split_gemm: augS {tuple(aug_s.shape)} "
                         f"{aug_s.dtype}, projS {tuple(proj_s.shape)} "
                         f"{proj_s.dtype}, gconsts {tuple(gconsts.shape)} "
                         f"{gconsts.dtype} (contiguous bf16 (N, 3 F_pad) "
                         f"and (C, 3 F_pad), F_pad a multiple of {K_TILE}; "
                         f"float32 (C,))")
    _require_cuda("loglike_split_gemm", aug_s, proj_s, gconsts)
    rows, c = aug_s.shape[0], proj_s.shape[0]
    gc = gconsts.contiguous()
    out = torch.empty((rows, c), dtype=torch.float32, device=aug_s.device)
    with torch.cuda.device(aug_s.device):
        rc = _library().sg_loglike_split_gemm(
            aug_s.data_ptr(), proj_s.data_ptr(), gc.data_ptr(),
            out.data_ptr(), rows, c, aug_s.shape[1] // 3,
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "fused_loglike (split GEMM)")
    return out


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
        out = loglike_split_gemm(aug_split(x), proj_split_kmajor(quad_proj),
                                 gconsts)
        self.launches += 1
        return out.reshape(*x.shape[:-1], quad_proj.shape[1])


fused_loglike = _FusedLoglike()
