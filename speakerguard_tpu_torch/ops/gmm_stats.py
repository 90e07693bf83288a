"""Fused GMM Baum-Welch statistics of the fast attack-gradient path: CUDA
kernels + plain versions, forward and backward.

Port of the Pallas TPU kernels speakerguard_tpu/ops/pallas_gmm_stats.py
``_stats_fwd`` and ``_stats_bwd`` and of their custom VJP ``fused_stats``:

    loglike[b,t,c] = gconsts[c] + aug16(x_bt) . proj16[:, c]
    posts          = softmax_c(loglike)
    zeroth[b,c]    = sum_t posts[b,t,c]
    first[b,c,d]   = sum_t posts16[b,t,c] x16[b,t,d]

with bf16 operands and f32 accumulation, and the bf16 posteriors posts16 as
the only residual of the backward.  The rounding points, which kernel and
plain version share (the JAX kernels run in interpret mode are the
reference):

  1. x16 = bf16(x); aug16 = [x16, bf16(x16[r] x16[c])].
  2. loglike = f32-accumulated aug16 . proj16 + gconsts.
  3. posts in f32; zeroth = sum_t posts in f32; first = posts16^T x16.
  4. backward: dp = dz + x16 . bf16(df)^T; dl = posts (dp - sum_c posts dp)
     with posts = f32(posts16); daug = bf16(dl) . proj16^T; dx = chain(daug,
     unrounded x) + daug[:, :D] + posts16 . bf16(df).

The plain versions emulate "bf16 operands, f32 accumulation" by up-casting
the bf16-rounded operands to float32 before each product (a product of two
bf16 values is exact in float32).  On CUDA tensors ``stats_fwd`` runs the
three launches of ``csrc/gmm_stats_fwd.cu`` on the N = B T flattened rows
(each with a plain version here, which the card's checks compare it with):

  1. ``augment16_padded``: aug16 (N, F_pad) bf16, F_pad = round_up(F, 64);
  2. ``loglike_partials``: loglike = aug16 . projK^T + gconsts in f32 on
     TMA + wgmma, with projK = ``proj_kmajor(proj16)`` (C, F_pad), and the
     per-(row, 256-column tile) softmax partials (max, sum exp(l - max));
  3. ``normalise_stats``: posts from the combined partials, posts16,
     zeroth and first.

``stats_bwd`` runs the three launches of ``csrc/gmm_stats_bwd.cu``, each
with its plain version too:

  1. ``dl_direct``: bf16(dl) (N, C) and the direct term posts16 . bf16(df)
     (N, D), dp on the tensor cores;
  2. ``daug_gemm``: daug = bf16(dl) . proj16^T in f32 on TMA + wgmma;
  3. ``chain_sum``: dx = daug[:, :D] + chain(daug[:, D:], x) + direct.

On CPU tensors each wrapper and launch helper runs its plain version.  A
helper calls its entry point through ``launch``, its library's by default;
a wrapper passes its own, and the call's last launch (``_launch``) counts
the call.
"""

import torch
import torch.nn.functional as F

from speakerguard_tpu_torch.ops._build import (INT, PTR, KernelWrapper,
                                               Library, on_card)
from speakerguard_tpu_torch.ops.gmm_loglike import (K_TILE, check_operands,
                                                    packed_indices,
                                                    padded_k, pair_table)

N_TILE = 256  # loglike columns of one softmax partial (the GEMM's tile)
MAX_D_CARD = 128  # the normalise and dl launches hold D / 16 accumulators
TMA_ALIGN = 8  # a TMA operand's bf16 row stride is a multiple of 16 bytes


def _bf(t: torch.Tensor) -> torch.Tensor:
    """bf16-rounded values, held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def chain_plain(dq: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """VJP of the packed outer product: dq (..., P) -> dx (..., D) with
    dx_r += dq_p x_c and dx_c += dq_p x_r for p = (r, c), in float32."""
    rows, cols = packed_indices(x.shape[-1], x.device)
    dx = torch.zeros_like(x)
    dx.index_add_(-1, rows, dq * x[..., cols])
    dx.index_add_(-1, cols, dq * x[..., rows])
    return dx


def posteriors_plain(x: torch.Tensor, proj16: torch.Tensor,
                     gconsts: torch.Tensor) -> torch.Tensor:
    """The float32 posteriors (B, T, C) of rounding points 1-3."""
    x16 = _bf(x)
    rows, cols = packed_indices(x.shape[-1], x.device)
    aug16 = torch.cat([x16, _bf(x16[..., rows] * x16[..., cols])], dim=-1)
    loglike = aug16 @ proj16.to(torch.float32) + gconsts
    e = torch.exp(loglike - loglike.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def stats_fwd_plain(x: torch.Tensor, proj16: torch.Tensor,
                    gconsts: torch.Tensor):
    """x (B, T, D) f32, proj16 (F, C) bf16, gconsts (C,) f32 ->
    (zeroth (B, C) f32, first (B, C, D) f32, posts16 (B, T, C) bf16)."""
    posts = posteriors_plain(x, proj16, gconsts)
    posts16 = posts.to(torch.bfloat16)
    first = posts16.to(torch.float32).mT @ _bf(x)
    return posts.sum(dim=-2), first, posts16


def stats_bwd_plain(x: torch.Tensor, proj16: torch.Tensor,
                    posts16: torch.Tensor, dzeroth: torch.Tensor,
                    dfirst: torch.Tensor) -> torch.Tensor:
    """The input cotangent dx (B, T, D) f32 from the forward's posts16 and
    the cotangents dzeroth (B, C), dfirst (B, C, D)."""
    b, t, d = x.shape
    dl = dl_plain(x, posts16, dzeroth, dfirst).reshape(b, t, -1)
    daug = _bf(dl) @ proj16.to(torch.float32).T
    dx = chain_plain(daug[..., d:], x) + daug[..., :d]
    return dx + posts16.to(torch.float32) @ _bf(dfirst)


def dl_plain(x: torch.Tensor, posts16: torch.Tensor,
             dzeroth: torch.Tensor, dfirst: torch.Tensor) -> torch.Tensor:
    """The f32 softmax VJP dl (N, C) over the flattened rows: dp = dz +
    x16 . bf16(df)^T, dl = posts (dp - sum_c posts dp)."""
    dp = dzeroth[:, None, :] + _bf(x) @ _bf(dfirst).mT
    posts = posts16.to(torch.float32)
    dl = posts * (dp - (posts * dp).sum(dim=-1, keepdim=True))
    return dl.reshape(-1, dl.shape[-1])


def dl_direct_plain(x: torch.Tensor, posts16: torch.Tensor,
                    dzeroth: torch.Tensor, dfirst: torch.Tensor):
    """x (B, T, D) f32, posts16 (B, T, C) bf16, dzeroth (B, C), dfirst
    (B, C, D) f32 -> (bf16(dl) (N, C), direct = posts16 . bf16(df) (N, D)
    f32)."""
    direct = posts16.to(torch.float32) @ _bf(dfirst)
    return (dl_plain(x, posts16, dzeroth, dfirst).to(torch.bfloat16),
            direct.reshape(-1, x.shape[-1]))


def daug_plain(dl16: torch.Tensor, proj16: torch.Tensor) -> torch.Tensor:
    """bf16(dl) (N, C), proj16 (F, C) bf16 -> daug (N, F) f32."""
    return dl16.to(torch.float32) @ proj16.to(torch.float32).T


def chain_sum_plain(daug: torch.Tensor, x: torch.Tensor,
                    direct: torch.Tensor) -> torch.Tensor:
    """daug (N, F) f32, x (B, T, D) f32, direct (N, D) f32 -> dx (B, T, D):
    daug[:, :D] + (Q + diag Q) x + direct, with Q the symmetric D x D
    matrix Q[r, c] = Q[c, r] = daug[:, D + p] for p = (r, c) (chain_plain's
    function, which adds dq_p x_r twice when r = c)."""
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    rows, cols = packed_indices(d, x.device)
    dq = daug[:, d:d + rows.numel()]
    q = daug.new_zeros((xf.shape[0], d, d))
    q[:, rows, cols] = dq
    q[:, cols, rows] = dq
    quad = (q @ xf[..., None])[..., 0] + torch.diagonal(q, dim1=1,
                                                        dim2=2) * xf
    return (daug[:, :d] + quad + direct).reshape(b, t, d)


def augment16_padded_plain(x: torch.Tensor) -> torch.Tensor:
    """x (..., D) f32 -> aug16 (N, F_pad) bf16 over the flattened rows:
    [x16, bf16(x16[r] x16[c])] and zero pad columns."""
    d = x.shape[-1]
    x16 = _bf(x.reshape(-1, d))
    rows, cols = packed_indices(d, x.device)
    aug = torch.cat([x16, _bf(x16[:, rows] * x16[:, cols])], dim=-1)
    return F.pad(aug, (0, padded_k(aug.shape[-1]) - aug.shape[-1])).to(
        torch.bfloat16)


def proj_kmajor(proj16: torch.Tensor) -> torch.Tensor:
    """proj16 (F, C) bf16 -> projK (C, F_pad) bf16, K-major with zero pad
    columns: the GEMM's B operand, rows 128-byte aligned for TMA."""
    f, c = proj16.shape
    out = proj16.new_zeros((c, padded_k(f)))
    out[:, :f] = proj16.T
    return out


def tile_partials(loglike: torch.Tensor) -> torch.Tensor:
    """loglike (N, C) -> part (N, ceil(C / 256), 2): each 256-column tile's
    max and sum of exp(l - max) over its columns < C."""
    c = loglike.shape[-1]
    n_ct = -(-c // N_TILE)
    tiles = F.pad(loglike, (0, n_ct * N_TILE - c), value=-torch.inf
                  ).reshape(-1, n_ct, N_TILE)
    m = tiles.amax(dim=-1)
    s = torch.exp(tiles - m[..., None]).sum(dim=-1)
    return torch.stack([m, s], dim=-1)


def loglike_partials_plain(aug16: torch.Tensor, projk: torch.Tensor,
                           gconsts: torch.Tensor):
    """aug16 (N, F_pad), projK (C, F_pad) bf16, gconsts (C,) f32 ->
    (loglike (N, C) f32, its ``tile_partials``)."""
    loglike = aug16.to(torch.float32) @ projk.to(torch.float32).T + gconsts
    return loglike, tile_partials(loglike)


def combine_partials(part: torch.Tensor):
    """part (N, tiles, 2) -> each row's max and sum of exp(l - max) (N, 1)
    over all its columns."""
    m = part[..., 0].amax(dim=-1, keepdim=True)
    s = (part[..., 1] * torch.exp(part[..., 0] - m)).sum(dim=-1,
                                                         keepdim=True)
    return m, s


def normalise_stats_plain(loglike: torch.Tensor, part: torch.Tensor,
                          x: torch.Tensor):
    """loglike (N, C) f32 and its partials, x (B, T, D) f32 -> (zeroth
    (B, C), first (B, C, D), posts16 (B, T, C))."""
    b, t, d = x.shape
    m, s = combine_partials(part)
    posts = (torch.exp(loglike - m) / s).reshape(b, t, -1)
    posts16 = posts.to(torch.bfloat16)
    first = posts16.to(torch.float32).mT @ _bf(x)
    return posts.sum(dim=-2), first, posts16


# The argument types of the C entry points (one a launch) of
# csrc/gmm_stats_fwd.cu and csrc/gmm_stats_bwd.cu, in order.
FWD_ARGTYPES = {
    # x, pairs, aug16, rows, d, f_pad, stream
    "sg_stats_fwd_aug16": [PTR, PTR, PTR, INT, INT, INT, PTR],
    # aug16, projk, gconsts, loglike, part, rows, c, f_pad, stream
    "sg_stats_fwd_loglike": [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, PTR],
    # loglike, ld, part, x, zeroth, first, posts16, b, t, d, c, stream
    "sg_stats_fwd_normalise": [PTR, INT, PTR, PTR, PTR, PTR, PTR, INT, INT,
                               INT, INT, PTR],
}
BWD_ARGTYPES = {
    # x, posts16, dz, df16, dl16, ldc, direct, b, t, d, c, stream
    "sg_stats_bwd_dl": [PTR, PTR, PTR, PTR, PTR, INT, PTR, INT, INT, INT,
                        INT, PTR],
    # dl16, ldc, proj, ldp, daug, ldf, rows, c, f, stream
    "sg_stats_bwd_daug": [PTR, INT, PTR, INT, PTR, INT, INT, INT, INT, PTR],
    # daug, ldf, x, direct, dx, rows, d, stream
    "sg_stats_bwd_chain": [PTR, INT, PTR, PTR, PTR, INT, INT, PTR],
}
FWD_LIB = Library("gmm_stats_fwd", FWD_ARGTYPES)
BWD_LIB = Library("gmm_stats_bwd", BWD_ARGTYPES)


def augment16_padded(x: torch.Tensor, launch=FWD_LIB.launch) -> torch.Tensor:
    """Launch 1 of ``stats_fwd``: ``augment16_padded_plain``'s function."""
    if not on_card(x, "augment16_padded"):
        return augment16_padded_plain(x)
    d = x.shape[-1]
    xc = x.contiguous()
    rows = xc.numel() // d
    pairs = pair_table(d, x.device)
    aug16 = torch.empty((rows, padded_k(d + d * (d + 1) // 2)),
                        dtype=torch.bfloat16, device=x.device)
    launch("sg_stats_fwd_aug16", x.device, xc, pairs, aug16, rows, d,
           aug16.shape[1])
    return aug16


def loglike_partials(aug16: torch.Tensor, projk: torch.Tensor,
                     gconsts: torch.Tensor, launch=FWD_LIB.launch):
    """Launch 2 of ``stats_fwd``: ``loglike_partials_plain``'s function.
    On the card loglike is an (N, C) view of an (N, round_up(C, 256))
    buffer."""
    if not on_card(aug16, "loglike_partials"):
        return loglike_partials_plain(aug16, projk, gconsts)
    rows, f_pad = aug16.shape
    c = projk.shape[0]
    if (projk.shape[1] != f_pad or f_pad % K_TILE or gconsts.shape != (c,)
            or aug16.dtype != torch.bfloat16 or projk.dtype != torch.bfloat16
            or gconsts.dtype != torch.float32
            or not (aug16.is_contiguous() and projk.is_contiguous())):
        raise ValueError(f"loglike_partials: aug16 {tuple(aug16.shape)}, "
                         f"projK {tuple(projk.shape)}, gconsts "
                         f"{tuple(gconsts.shape)}")
    n_ct = -(-c // N_TILE)
    gc = gconsts.contiguous()
    loglike = torch.empty((rows, n_ct * N_TILE), dtype=torch.float32,
                          device=aug16.device)
    part = torch.empty((rows, n_ct, 2), dtype=torch.float32,
                       device=aug16.device)
    launch("sg_stats_fwd_loglike", aug16.device, aug16, projk, gc, loglike,
           part, rows, c, f_pad)
    return loglike[:, :c], part


def normalise_stats(loglike: torch.Tensor, part: torch.Tensor,
                    x: torch.Tensor, launch=FWD_LIB.launch):
    """Launch 3 of ``stats_fwd``: ``normalise_stats_plain``'s function.
    loglike may have a row stride larger than C."""
    if not on_card(x, "normalise_stats"):
        return normalise_stats_plain(loglike, part, x)
    b, t, d = x.shape
    c = loglike.shape[1]
    if (d > MAX_D_CARD or loglike.shape[0] != b * t or loglike.stride(1) != 1
            or part.shape != (b * t, -(-c // N_TILE), 2)
            or not part.is_contiguous() or x.dtype != torch.float32
            or loglike.dtype != torch.float32 or part.dtype != torch.float32):
        raise ValueError(f"normalise_stats: loglike {tuple(loglike.shape)}, "
                         f"part {tuple(part.shape)}, x {tuple(x.shape)} "
                         f"(D <= {MAX_D_CARD} on the card)")
    xc = x.contiguous()
    dev = x.device
    zeroth = torch.empty((b, c), dtype=torch.float32, device=dev)
    first = torch.empty((b, c, d), dtype=torch.float32, device=dev)
    posts16 = torch.empty((b, t, c), dtype=torch.bfloat16, device=dev)
    launch("sg_stats_fwd_normalise", dev, loglike, loglike.stride(0), part,
           xc, zeroth, first, posts16, b, t, d, c)
    return zeroth, first, posts16


def dl_direct(x: torch.Tensor, posts16: torch.Tensor, dzeroth: torch.Tensor,
              dfirst: torch.Tensor, launch=BWD_LIB.launch):
    """Launch 1 of ``stats_bwd``: ``dl_direct_plain``'s function.  On the
    card bf16(dl) is an (N, C) view of an (N, round_up(C, 8)) buffer whose
    pad columns are 0; bf16(df) goes in as a (B, C, round_up(D, 16)) copy
    with zero pad columns, made here in plain torch."""
    b, t, d = x.shape
    c = posts16.shape[-1]
    if (posts16.shape != (b, t, c) or dzeroth.shape != (b, c)
            or dfirst.shape != (b, c, d) or posts16.dtype != torch.bfloat16
            or not all(a.dtype == torch.float32 for a in (x, dzeroth,
                                                          dfirst))):
        raise ValueError(f"dl_direct: x {tuple(x.shape)}, posts16 "
                         f"{tuple(posts16.shape)} {posts16.dtype}, dzeroth "
                         f"{tuple(dzeroth.shape)}, dfirst "
                         f"{tuple(dfirst.shape)} (float32 but posts16)")
    if not on_card(x, "dl_direct"):
        return dl_direct_plain(x, posts16, dzeroth, dfirst)
    if d > MAX_D_CARD:
        raise ValueError(f"dl_direct: D = {d} > {MAX_D_CARD} on the card")
    xc, pc, zc = (a.contiguous() for a in (x, posts16, dzeroth))
    # bf16(df) with D padded to whole 16-column tensor-core tiles
    dp = -(-d // 16) * 16
    df16 = (torch.empty if dp == d else torch.zeros)(
        (b, c, dp), dtype=torch.bfloat16, device=x.device)
    df16[..., :d] = dfirst
    ldc = -(-c // TMA_ALIGN) * TMA_ALIGN
    dl16 = torch.empty((b * t, ldc), dtype=torch.bfloat16, device=x.device)
    direct = torch.empty((b * t, d), dtype=torch.float32, device=x.device)
    launch("sg_stats_bwd_dl", x.device, xc, pc, zc, df16, dl16, ldc, direct,
           b, t, d, c)
    return dl16[:, :c], direct


def _tma_rows(a: torch.Tensor) -> torch.Tensor:
    """A 2-D bf16 matrix as TMA reads it: unit column stride, a row stride
    of a multiple of 8 elements and a 16-byte aligned start; ``a`` itself
    or a zero-padded copy."""
    if (a.stride(1) == 1 and a.stride(0) % TMA_ALIGN == 0
            and a.data_ptr() % 16 == 0):
        return a
    return F.pad(a, (0, -a.shape[1] % TMA_ALIGN)).contiguous()


def daug_gemm(dl16: torch.Tensor, proj16: torch.Tensor,
              launch=BWD_LIB.launch) -> torch.Tensor:
    """Launch 2 of ``stats_bwd``: ``daug_plain``'s function.  On the card
    daug is an (N, F) view of an (N, round_up(F, 256)) buffer."""
    if (dl16.ndim != 2 or proj16.ndim != 2
            or proj16.shape[1] != dl16.shape[1]
            or dl16.dtype != torch.bfloat16
            or proj16.dtype != torch.bfloat16):
        raise ValueError(f"daug_gemm: dl16 {tuple(dl16.shape)} "
                         f"{dl16.dtype}, proj16 {tuple(proj16.shape)} "
                         f"{proj16.dtype} (bf16, (N, C) and (F, C))")
    if not on_card(dl16, "daug_gemm"):
        return daug_plain(dl16, proj16)
    rows, c = dl16.shape
    f = proj16.shape[0]
    a, pj = _tma_rows(dl16), _tma_rows(proj16)
    ldf = -(-f // N_TILE) * N_TILE
    daug = torch.empty((rows, ldf), dtype=torch.float32, device=dl16.device)
    launch("sg_stats_bwd_daug", dl16.device, a, a.stride(0), pj, pj.stride(0),
           daug, ldf, rows, c, f)
    return daug[:, :f]


def chain_sum(daug: torch.Tensor, x: torch.Tensor, direct: torch.Tensor,
              launch=BWD_LIB.launch) -> torch.Tensor:
    """Launch 3 of ``stats_bwd``: ``chain_sum_plain``'s function.  daug may
    have a row stride larger than F (a multiple of 4)."""
    b, t, d = x.shape
    n, f = b * t, d + d * (d + 1) // 2
    if (daug.shape != (n, f) or direct.shape != (n, d)
            or not all(a.dtype == torch.float32 for a in (daug, x, direct))):
        raise ValueError(f"chain_sum: daug {tuple(daug.shape)}, x "
                         f"{tuple(x.shape)}, direct {tuple(direct.shape)} "
                         f"(float32, (N, F), (B, T, D), (N, D))")
    if not on_card(x, "chain_sum"):
        return chain_sum_plain(daug, x, direct)
    if daug.stride(1) != 1 or daug.stride(0) % 4 or daug.data_ptr() % 16:
        raise ValueError(f"chain_sum: daug's rows (stride "
                         f"{daug.stride()}) must start 16-byte aligned")
    xc, dc = x.contiguous(), direct.contiguous()
    dx = torch.empty((b, t, d), dtype=torch.float32, device=x.device)
    launch("sg_stats_bwd_chain", x.device, daug, daug.stride(0), xc, dc, dx,
           n, d)
    return dx


def _check(x, proj16, gconsts):
    check_operands(x, proj16, gconsts, torch.bfloat16)
    if x.ndim != 3 or 0 in x.shape:
        raise ValueError(f"expected x (B, T, D) with B, T, D >= 1, got "
                         f"{tuple(x.shape)}")


class _StatsFwd(KernelWrapper):
    """``stats_fwd(x, proj16, gconsts) -> (zeroth, first, posts16)``."""

    name = "stats_fwd"
    lib = FWD_LIB

    def __call__(self, x, proj16, gconsts):
        _check(x, proj16, gconsts)
        if not self.route(x):
            return stats_fwd_plain(x, proj16, gconsts)
        launch = self.lib.launch
        loglike, part = loglike_partials(augment16_padded(x, launch),
                                         proj_kmajor(proj16), gconsts, launch)
        return normalise_stats(loglike, part, x, self._launch)


class _StatsBwd(KernelWrapper):
    """``stats_bwd(x, proj16, posts16, dzeroth, dfirst) -> dx``."""

    name = "stats_bwd"
    lib = BWD_LIB

    def __call__(self, x, proj16, posts16, dzeroth, dfirst):
        b, t, d = x.shape
        c = proj16.shape[1]
        if (posts16.shape != (b, t, c) or posts16.dtype != torch.bfloat16
                or dzeroth.shape != (b, c) or dfirst.shape != (b, c, d)
                or proj16.shape[0] != d + d * (d + 1) // 2
                or proj16.dtype != torch.bfloat16
                or x.dtype != torch.float32):
            raise ValueError(f"stats_bwd: posts16 {tuple(posts16.shape)} "
                             f"{posts16.dtype}, dzeroth "
                             f"{tuple(dzeroth.shape)}, dfirst "
                             f"{tuple(dfirst.shape)}, proj16 "
                             f"{tuple(proj16.shape)} {proj16.dtype} do not "
                             f"fit x {tuple(x.shape)} {x.dtype}")
        dzeroth = dzeroth.to(torch.float32)
        dfirst = dfirst.to(torch.float32)
        if not self.route(x):
            return stats_bwd_plain(x, proj16, posts16, dzeroth, dfirst)
        launch = self.lib.launch
        dl16, direct = dl_direct(x, posts16, dzeroth, dfirst, launch)
        return chain_sum(daug_gemm(dl16, proj16, launch), x, direct,
                         self._launch)


stats_fwd = _StatsFwd()
stats_bwd = _StatsBwd()


class _FusedStats(torch.autograd.Function):
    """(zeroth, first) = fused_stats(proj16, gconsts, feats), differentiable
    in feats only: the forward saves posts16, the backward is ``stats_bwd``
    and returns None for the GMM parameters (never attack variables)."""

    @staticmethod
    def forward(ctx, proj16, gconsts, feats):
        zeroth, first, posts16 = stats_fwd(feats, proj16, gconsts)
        ctx.save_for_backward(proj16, feats, posts16)
        return zeroth, first

    @staticmethod
    def backward(ctx, dzeroth, dfirst):
        proj16, feats, posts16 = ctx.saved_tensors
        return None, None, stats_bwd(feats, proj16, posts16, dzeroth, dfirst)


def fused_stats(proj16: torch.Tensor, gconsts: torch.Tensor,
                feats: torch.Tensor):
    """feats (B, T, D) -> (zeroth (B, C), first (B, C, D)), fused."""
    return _FusedStats.apply(proj16, gconsts, feats)
