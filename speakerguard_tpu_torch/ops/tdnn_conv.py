"""The TDNN's dilated convolutions, and the bf16 fast block's kernel.

The convolutions in (B, T, C): each dilated convolution as one GEMM over its
k taps (``_im2col`` gathers the k shifted copies of the input side by side,
tap-major).  Like XLA's convolutions, the GEMM accumulates in float32 and
rounds once to its output type; ``_mm`` gives the float32-output bf16
products of ``_BlockFast``'s backward (``torch.mm``'s out_dtype form), which
no convolution call offers.

``tdnn_conv`` runs the conv -> ReLU -> BN block of ``_BlockFastBf16``
(models/tdnn.py) forward and backward.  Its rounding points, which kernel
and plain version share:

  1. forward: y = f32(bf16(x16 . w16)) + bias (the conv's float32 sum rounded
     once to bf16); m = y > 0; out = bf16(((m ? y : 0) - mean) s), s =
     rsqrt(var + eps);
  2. backward: gy = bf16(m ? f32(g) s : 0); gx = bf16(gy . w16 transposed),
     float32 sums rounded once.

On a CPU tensor it runs the plain version (``block_fwd_plain``,
``block_bwd_plain``: the im2col GEMMs and torch's elementwise passes).  On a
CUDA tensor it launches ``csrc/tdnn_conv.cu``, an implicit GEMM whose taps
are read in place by TMA, with the epilogue and the backward's operand
formed inside the kernel (the source's header says how).  Its operands:

- activations are the first T rows of each utterance of a (B, Ts, ld)
  row-major buffer (``rows_layout``): every layer keeps its input's row
  stride Ts, so the output (B, T_out, C_out) is a view of (B - 1) Ts + T_out
  rows, and the rows between T_out and Ts of an utterance are junk that
  nothing reads as values.  ld is a multiple of 8 (16 bytes, for TMA):
  layer 1's 30 channels are copied into rows of 32;
- the weights are packed once (``weight_packs``, kept on the weight tensor
  until it changes): (C_out, k, C_in padded to 64) for the forward and
  (C_in, k, C_out padded to 64) with the taps reversed for the backward;
- the ReLU mask is saved as bits: (B, T_out, M) uint8, one byte a row and 8
  channels, M a multiple of 8 (``mask_bool`` reads either form back).

ECAPA-TDNN's blocks (models/ecapa.py) take a second form, on both routes,
selected by passing ``gamma`` and ``beta``:

- the BN has an affine part.  out = bf16(r a + c), r = m ? y : 0, with a =
  s gamma and c = beta - mean a (``affine_bn``), an f32 product and then
  an f32 add; the backward's scale is a;
- the convolution is "same" with reflect padding (T_out = T; odd k, P =
  (k - 1) dilation / 2).  The input is gathered into T + 2 P rows an
  utterance, its P rows at each end the reflected rows (``reflect_rows``),
  and the valid convolution of that is the output; the input cotangent of
  the padded rows is folded back onto the rows they reflect
  (``fold_reflected``: each edge row's bf16 cotangent plus its mirror's,
  rounded once to bf16).
"""

import functools

import torch
import torch.nn.functional as F

from speakerguard_tpu_torch.ops._build import (INT, PTR, KernelWrapper,
                                               Library)

BN_EPS = 1e-5
TILE_N = 256   # output columns of the kernel's tile: the vectors' padding
TILE_K = 64    # channels of a k-tile: the packed weights' padding


def _im2col(x, k, dilation, t_out):
    """(B, T, C) -> (B t_out, k C): row (b, t) holds x[b, t + j dilation]
    for the k taps j, tap-major."""
    if k == 1:
        return x[:, :t_out].reshape(-1, x.shape[-1])
    return torch.cat([x[:, j * dilation:j * dilation + t_out]
                      for j in range(k)], dim=-1).view(-1, k * x.shape[-1])


def _mm(a, b, out_dtype):
    """a @ b; with ``out_dtype`` wider than the operands, the float32
    output of bf16 operands (``torch.mm``'s out_dtype form, CUDA only)."""
    if out_dtype == a.dtype:
        return a @ b
    return torch.mm(a, b, out_dtype=out_dtype)


def _conv1d(x, w, bias, dilation):
    """Valid dilated convolution in (B, T, C): x (B, T, in) and w (out, in,
    k), both of one dtype -> (B, T - (k-1) dilation, out), as one GEMM over
    the k taps with float32 accumulation, rounded once to that dtype."""
    k = w.shape[2]
    t_out = x.shape[1] - (k - 1) * dilation
    wm = w.permute(2, 1, 0).reshape(-1, w.shape[0])        # (k in, out)
    y = _im2col(x, k, dilation, t_out) @ wm
    y = y.view(x.shape[0], t_out, -1)
    return y if bias is None else y + bias


def _conv1d_input_grad(gy, w, dilation, out_dtype=None):
    """The input cotangent of ``_conv1d``: gy (B, T', out) and w of gy's
    dtype -> (B, T' + (k-1) dilation, in), the convolution of gy padded by
    (k-1) dilation on both sides with the taps reversed, as one GEMM
    rounded once to ``out_dtype`` (default gy's)."""
    k = w.shape[2]
    pad = (k - 1) * dilation
    t_in = gy.shape[1] + pad
    gyp = F.pad(gy, (0, 0, pad, pad)) if pad else gy
    wm = w.flip(2).permute(2, 0, 1).reshape(-1, w.shape[1])
    gx = _mm(_im2col(gyp, k, dilation, t_in), wm, out_dtype or gy.dtype)
    return gx.view(gy.shape[0], t_in, -1)


def affine_bn(mean, var, gamma, beta):
    """(a, c) of an affine BN with running statistics: BN(r) = r a + c, a =
    rsqrt(var + eps) gamma, c = beta - mean a, in float32."""
    a = torch.rsqrt(var + BN_EPS) * gamma
    return a, beta - mean * a


def affine_bn_kept(mean, var, gamma, beta):
    """``affine_bn``'s (a, c), computed once and kept on ``var`` until one
    of the four is replaced or changed in place (a model's BN buffers)."""
    return _cached(var, "_affine_bn", (mean, var, gamma, beta),
                   lambda: affine_bn(mean, var, gamma, beta))


def same_pad(k: int, dilation: int) -> int:
    """P, the rows a "same" convolution reflects at each end."""
    if (k - 1) * dilation % 2:
        raise ValueError(f"a same convolution needs an odd span: k {k}, "
                         f"dilation {dilation}")
    return (k - 1) * dilation // 2


@functools.lru_cache(maxsize=64)
def _reflect_indices(t: int, pad: int, device: str):
    """(gather, left, right) index tensors of T frames reflected by ``pad``
    at each end: padded row p reads frame reflect(p - pad); the padded
    rows 0 .. pad - 1 fold onto frames ``left``, the rows pad + T .. onto
    frames ``right``."""
    p = torch.arange(t + 2 * pad) - pad
    gather = torch.where(p < 0, -p, torch.where(p >= t, 2 * (t - 1) - p, p))
    r = torch.arange(pad)
    return tuple(v.to(device) for v in (gather, pad - r, t - 2 - r))


def reflect_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x (B, T, C) -> (B, T + 2 pad, C) with the ``pad`` frames at each end
    reflected (torch's reflect padding: the edge frame not repeated), in
    rows of round_up(C, 8); one gather."""
    gather, _, _ = _reflect_indices(x.shape[1], pad, str(x.device))
    xp = x.index_select(1, gather)
    if xp.shape[-1] % 8 == 0:
        return xp
    out = rows_tensor(xp.shape, xp.shape[1], _round_up(xp.shape[-1], 8),
                      xp.dtype, xp.device)
    return out.copy_(xp)


def fold_reflected(full: torch.Tensor, pad: int) -> torch.Tensor:
    """The cotangent of ``reflect_rows``' input from the cotangent ``full``
    (B, T + 2 pad, C) of its output: the middle T rows, each edge row added
    onto the row it reflects (in ``full``'s storage, in its dtype; the
    edges read in place, one add a row)."""
    t = full.shape[1] - 2 * pad
    _, left, right = _reflect_indices(t, pad, str(full.device))
    core = full[:, pad:pad + t]
    core.index_add_(1, left, full[:, :pad])
    return core.index_add_(1, right, full[:, pad + t:])


def cotangent_rows(mask: torch.Tensor, shape) -> torch.Tensor:
    """An uninitialised bf16 output cotangent of ``shape`` (B, T, C) for
    the block whose saved mask is ``mask``, in the mask's row stride and
    rows of round_up(C, 8): the backward's kernel reads it in place."""
    ts, _ = rows_layout(mask)
    return rows_tensor(shape, ts, _round_up(shape[-1], 8), torch.bfloat16,
                       mask.device)


def block_fwd_plain(x, w, b, mean, var, dilation, gamma=None, beta=None):
    """The plain forward on (B, T, C): bf16 x and the bf16-rounded weights
    through the im2col GEMM, then the bias, ReLU and BN in float32 -> (out
    bf16, the bool ReLU mask, w16); with ``gamma``, ``beta`` ECAPA's form
    (x reflected at its ends, an affine BN)."""
    w16 = w.to(torch.bfloat16)
    if gamma is not None and w.shape[2] > 1:
        x = reflect_rows(x, same_pad(w.shape[2], dilation))
    y = torch.add(_conv1d(x, w16, None, dilation), b)   # float32
    mask = y > 0
    if gamma is None:
        out = (torch.where(mask, y, 0.0) - mean) * torch.rsqrt(var + BN_EPS)
    else:
        a, c = affine_bn(mean, var, gamma, beta)
        out = torch.where(mask, y, 0.0) * a + c
    return out.to(torch.bfloat16), mask, w16


def block_bwd_plain(g, mask, w16, var, dilation, gamma=None):
    """The plain input gradient: gy = bf16(where(mask, g s, 0)) through
    the transposed im2col GEMM, rounded once to bf16; with ``gamma`` (ECAPA's
    form) s gamma in place of s, and the padded rows folded back."""
    s = torch.rsqrt(var + BN_EPS)
    if gamma is not None:
        s = s * gamma
    gy = torch.where(mask, g * s, 0.0)  # float32
    gx = _conv1d_input_grad(gy.to(torch.bfloat16), w16, dilation)
    if gamma is None:
        return gx
    return fold_reflected(gx, same_pad(w16.shape[2], dilation))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def rows_layout(t: torch.Tensor):
    """(Ts, ld) of a (B, T, C) tensor held as the first T rows of each
    utterance of a (B, Ts, ld) row-major buffer; raises on any other
    layout."""
    if t.dim() != 3:
        raise ValueError(f"expected (B, T, C), got shape {tuple(t.shape)}")
    b, t_len, c = t.shape
    s0, s1, s2 = t.stride()
    whole = s1 > 0 and s0 % s1 == 0 and s0 // s1 >= t_len
    if (c > 1 and s2 != 1) or s1 < c or (b > 1 and not whole):
        raise ValueError(f"a (B, T, C) operand's rows must be channel-"
                         f"contiguous and utterances whole rows apart: "
                         f"shape {tuple(t.shape)}, strides {t.stride()}")
    return (s0 // s1 if whole else t_len), s1


def rows_tensor(shape, ts: int, ld: int, dtype, device) -> torch.Tensor:
    """An uninitialised (B, T, C) view onto the (B - 1) Ts + T rows of ld
    that its layout needs (``rows_layout`` gives back (Ts, ld))."""
    b, t, c = shape
    base = torch.empty(((b - 1) * ts + t) * ld, dtype=dtype, device=device)
    return base.as_strided((b, t, c), (ts * ld, ld, 1))


def empty_rows_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of ``t``'s shape and dtype in its rows
    layout: a cotangent that the layer below's kernel reads in place."""
    ts, ld = rows_layout(t)
    return rows_tensor(t.shape, ts, ld, t.dtype, t.device)


def _kernel_rows(t: torch.Tensor, ts: int) -> torch.Tensor:
    """``t`` if TMA can read its rows (row stride a multiple of 16 bytes,
    16-byte aligned, utterances ``ts`` rows apart), else a copy into rows
    of round_up(C, 8)."""
    t_ts, ld = rows_layout(t)
    if ((t_ts == ts or t.shape[0] == 1) and ld % 8 == 0
            and t.data_ptr() % 16 == 0):
        return t
    out = rows_tensor(t.shape, ts, _round_up(t.shape[-1], 8), t.dtype,
                      t.device)
    return out.copy_(t)


def _cached(owner: torch.Tensor, attr: str, keys: tuple, build):
    """``build()``, kept on ``owner`` until one of ``keys`` (tensors) is
    replaced or changed in place."""
    versions = tuple(k._version for k in keys)
    hit = getattr(owner, attr, None)
    if (hit is not None and len(hit[0]) == len(keys)
            and all(a is b for a, b in zip(hit[0], keys))
            and hit[1] == versions):
        return hit[2]
    value = build()
    setattr(owner, attr, (keys, versions, value))
    return value


def weight_packs(w: torch.Tensor):
    """(wf, wb): the kernel's bf16 weights for w (out, in, k), packed once.
    wf (out, k round_up(in, 64)), wf[o, j, c] = w[o, c, j]; wb (in, k
    round_up(out, 64)), wb[c, j, o] = w[o, c, k - 1 - j]; zeros past the
    channels."""
    def build():
        cout, cin, k = w.shape
        w16 = w.detach().to(torch.bfloat16)
        wf = torch.zeros(cout, k, _round_up(cin, TILE_K),
                         dtype=torch.bfloat16, device=w.device)
        wf[:, :, :cin] = w16.permute(0, 2, 1)
        wb = torch.zeros(cin, k, _round_up(cout, TILE_K),
                         dtype=torch.bfloat16, device=w.device)
        wb[:, :, :cout] = w16.flip(2).permute(1, 2, 0)
        return wf.view(cout, -1), wb.view(cin, -1)
    return _cached(w, "_tdnn_conv_packs", (w,), build)


def epilogue_vectors(b, mean, var, gamma=None, beta=None) -> torch.Tensor:
    """(3, round_up(C, 256)) float32: bias, BN mean and s = rsqrt(var +
    eps) (as ``_bn`` computes it), or with ``gamma``, ``beta`` bias, c and
    a (``affine_bn``), zero past C; kept on ``var``."""
    keys = (b, mean, var) if gamma is None else (b, mean, var, gamma, beta)

    def build():
        c = var.shape[0]
        vecs = torch.zeros(3, _round_up(c, TILE_N), dtype=torch.float32,
                           device=var.device)
        vecs[0, :c] = b
        if gamma is None:
            vecs[1, :c] = mean
            vecs[2, :c] = torch.rsqrt(var + BN_EPS)
        else:
            vecs[2, :c], vecs[1, :c] = affine_bn(mean, var, gamma, beta)
        return vecs
    return _cached(var, "_tdnn_conv_vecs", keys, build)


def mask_bool(mask: torch.Tensor, c: int) -> torch.Tensor:
    """The block's saved ReLU mask as a (B, T_out, c) bool tensor: the
    plain version's as it is, the kernel's bits unpacked."""
    if mask.dtype == torch.bool:
        return mask
    nbytes = -(-c // 8)
    shifts = torch.arange(8, device=mask.device, dtype=torch.uint8)
    bits = (mask[..., :nbytes, None] >> shifts) & 1
    return bits.reshape(*mask.shape[:-1], nbytes * 8)[..., :c].bool()


def _check_fwd(x, w, b, mean, var, dilation, gamma=None, beta=None):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"tdnn_conv takes a bf16 activation, not {x.dtype}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x (B, T, {w.shape[1] if w.dim() == 3 else '?'})"
                         f" and w (out, in, k) expected: x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    cout, _, k = w.shape
    if (gamma is None) != (beta is None):
        raise ValueError("an affine BN takes both gamma and beta")
    # ECAPA's same convolution reflects fewer rows than T at each end, and
    # its two edges fold onto rows apart
    same = gamma is not None
    span = (k - 1) * dilation + (2 if same and k > 1 else 0)
    if x.shape[1] <= span:
        raise ValueError(f"T = {x.shape[1]} frames is shorter than the "
                         f"{k}-tap filter at dilation {dilation}")
    if same:
        same_pad(k, dilation)
    vecs = (("b", b), ("mean", mean), ("var", var))
    if gamma is not None:
        vecs += (("gamma", gamma), ("beta", beta))
    for name, v in vecs:
        if tuple(v.shape) != (cout,):
            raise ValueError(f"{name} of shape {tuple(v.shape)}, expected "
                             f"({cout},)")
    for t in (w,) + tuple(v for _, v in vecs):
        if t.device != x.device:
            raise ValueError(f"tdnn_conv's operands lie on {x.device} and "
                             f"{t.device}")


# The argument types of csrc/tdnn_conv.cu's C entry points, in order (the
# launch dicts name their arguments in the same order).
ARGTYPES = {
    # x, x_rows, cin, x_ld, wf, k, vecs, vec_len, out, out_ld, mask,
    # mask_ld, rows, ts, t_out, cout, dil, affine, stream
    "sg_tdnn_conv_fwd": [PTR, INT, INT, INT, PTR, INT, PTR, INT, PTR, INT,
                         PTR, INT, INT, INT, INT, INT, INT, INT, PTR],
    # g, g_rows, g_ld, mask, mask_ld, s, vec_len, wb, k, gx, gx_ld, rows,
    # ts, t_in, cin, cout, dil, stream
    "sg_tdnn_conv_bwd": [PTR, INT, INT, PTR, INT, PTR, INT, PTR, INT, PTR,
                         INT, INT, INT, INT, INT, INT, INT, PTR],
    "sg_tdnn_conv_tile_n": [],
    "sg_tdnn_conv_tile_k": [],
}
LIB = Library("tdnn_conv", ARGTYPES, {"sg_tdnn_conv_tile_n": TILE_N,
                                      "sg_tdnn_conv_tile_k": TILE_K})


def _ext_rows(t: torch.Tensor, ts: int) -> int:
    """The flat rows a (B, T, C) operand of row stride ``ts`` spans."""
    return (t.shape[0] - 1) * ts + t.shape[1]


def fwd_operands(x, w, b, mean, var, dilation, gamma=None, beta=None):
    """The forward launch's operands, outputs allocated: a dict of the C
    entry point's arguments by name (tensors where it takes pointers), and
    the outputs out (B, T_out, C_out) bf16 and mask (B, T_out, M) uint8 as
    views in x's row stride.  With ``gamma`` and k > 1, x is first gathered
    into T + 2 P rows an utterance (``reflect_rows``), whose row stride the
    outputs take."""
    cout, _, k = w.shape
    if gamma is not None and k > 1:
        x = reflect_rows(x, same_pad(k, dilation))
    bsz, _, cin = x.shape
    ts, _ = rows_layout(x)
    x = _kernel_rows(x, ts)
    t_out = x.shape[1] - (k - 1) * dilation
    mask_ld = _round_up(-(-cout // 8), 8)
    out = rows_tensor((bsz, t_out, cout), ts, _round_up(cout, 8),
                      torch.bfloat16, x.device)
    mask = rows_tensor((bsz, t_out, mask_ld), ts, mask_ld, torch.uint8,
                       x.device)
    wf, _ = weight_packs(w)
    vecs = epilogue_vectors(b, mean, var, gamma, beta)
    return dict(x=x, x_rows=_ext_rows(x, ts), cin=cin, x_ld=x.stride(1),
                wf=wf, k=k, vecs=vecs, vec_len=vecs.shape[1], out=out,
                out_ld=out.stride(1), mask=mask, mask_ld=mask_ld,
                rows=_ext_rows(out, ts), ts=ts, t_out=t_out, cout=cout,
                dil=dilation, affine=int(gamma is not None))


def bwd_operands(g, mask, w, vecs, dilation):
    """The input-gradient launch's operands for the output cotangent g
    (B, T_out, C_out), the forward's mask bits and vectors: a dict as
    ``fwd_operands``', g copied into the mask's row stride where it lies
    elsewhere, and gx (B, T_in, C_in) bf16 allocated in that row stride
    (for ECAPA's form the cotangent of the reflect-gathered input)."""
    bsz, t_out, cout = g.shape
    ts, mask_ld = rows_layout(mask)
    g = _kernel_rows(g.to(torch.bfloat16), ts)
    _, wb = weight_packs(w)
    cin, k = w.shape[1], w.shape[2]
    t_in = t_out + (k - 1) * dilation
    gx = rows_tensor((bsz, t_in, cin), ts, _round_up(cin, 8),
                     torch.bfloat16, g.device)
    return dict(g=g, g_rows=_ext_rows(g, ts), g_ld=g.stride(1), mask=mask,
                mask_ld=mask_ld, s=vecs[2], vec_len=vecs.shape[1], wb=wb,
                k=k, gx=gx, gx_ld=gx.stride(1), rows=_ext_rows(gx, ts),
                ts=ts, t_in=t_in, cin=cin, cout=cout, dil=dilation)


class _Plan:
    """What a launch of one operand layout needs besides its tensors
    (``_TdnnConv._plans``): the launch dict (``fwd_operands``,
    ``bwd_operands``) with the ``dynamic`` entries, the tensors and the
    input's row stride (which a copy for alignment may change), to be
    filled per call; the outputs' allocations as (numel, size, stride);
    the forward's reflect padding; the input's row stride Ts."""

    __slots__ = ("template", "allocs", "pad", "ts")

    def __init__(self, op: dict, dynamic: tuple, allocs: tuple, ts: int,
                 pad: int = 0):
        self.template = {k: None if k in dynamic else v
                         for k, v in op.items()}
        self.allocs = {k: (op[k].untyped_storage().nbytes()
                           // op[k].element_size(), op[k].shape,
                           op[k].stride()) for k in allocs}
        self.ts, self.pad = ts, pad

    def alloc(self, name: str, dtype, device) -> torch.Tensor:
        n, size, stride = self.allocs[name]
        return torch.empty(n, dtype=dtype, device=device).as_strided(
            size, stride)

    def fill(self, **dynamic) -> dict:
        """The launch dict, in the entry point's order."""
        op = self.template.copy()
        op.update(dynamic)
        return op


class _TdnnConv(KernelWrapper):
    """``tdnn_conv.forward(x, w, b, mean, var, dilation, gamma=None,
    beta=None) -> (out, saved)`` and ``tdnn_conv.backward(g, *saved,
    dilation, gamma=None) -> gx``: the bf16 block's two directions (ECAPA's
    form with ``gamma``, ``beta``), ``saved`` what the backward of the same
    route reads (the plain version's: the bool mask, w16, var; the
    kernel's: the mask bits, w, the epilogue vectors, which hold the affine
    scale).  ``launches`` counts both directions' launches.

    A launch's checks and layout arithmetic (``_check_fwd``,
    ``fwd_operands``, ``bwd_operands``) run once per operand layout; the
    ``_Plan`` they leave makes each later launch of that layout its
    allocations, the tensors' pointers and the call (an attack step makes
    dozens of launches, and the host time they took set the pace of
    ECAPA's steps)."""

    name = "tdnn_conv"
    lib = LIB

    def __init__(self):
        super().__init__()
        self._plans = {}

    def forward(self, x, w, b, mean, var, dilation, gamma=None, beta=None):
        if not self.route(x):
            _check_fwd(x, w, b, mean, var, dilation, gamma, beta)
            out, mask, w16 = block_fwd_plain(x, w, b, mean, var, dilation,
                                             gamma, beta)
            return out, (mask, w16, var)
        vecs = (b, mean, var) if gamma is None else (b, mean, var, gamma,
                                                     beta)
        key = ("fwd", x.shape, x.stride(), x.dtype, x.device, w.shape,
               w.device, dilation, beta is None) + tuple(
                   (getattr(v, "shape", None), getattr(v, "device", None))
                   for v in vecs)
        plan = self._plans.get(key)
        if plan is None:
            _check_fwd(x, w, b, mean, var, dilation, gamma, beta)
            op = fwd_operands(x, w, b, mean, var, dilation, gamma, beta)
            pad = same_pad(w.shape[2], dilation) if (
                gamma is not None and w.shape[2] > 1) else 0
            self._plans[key] = _Plan(
                op, ("x", "x_ld", "wf", "vecs", "out", "mask"),
                ("out", "mask"), rows_layout(op["x"])[0], pad)
        else:
            xk = (reflect_rows(x, plan.pad) if plan.pad
                  else _kernel_rows(x, plan.ts))
            op = plan.fill(x=xk, x_ld=xk.stride(1), wf=weight_packs(w)[0],
                           vecs=epilogue_vectors(*vecs),
                           out=plan.alloc("out", torch.bfloat16, x.device),
                           mask=plan.alloc("mask", torch.uint8, x.device))
        self._launch("sg_tdnn_conv_fwd", x.device, *op.values())
        return op["out"], (op["mask"], w, op["vecs"])

    def backward(self, g, mask, w, v, dilation, gamma=None):
        if not self.route(g):
            return block_bwd_plain(g, mask, w, v, dilation, gamma)
        key = ("bwd", g.shape, g.stride(), g.dtype, mask.shape,
               mask.stride(), w.shape, v.shape, dilation)
        plan = self._plans.get(key)
        if plan is None:
            op = bwd_operands(g, mask, w, v, dilation)
            self._plans[key] = _Plan(op, ("g", "g_ld", "mask", "s", "wb",
                                          "gx"), ("gx",),
                                     rows_layout(mask)[0])
        else:
            gk = _kernel_rows(g.to(torch.bfloat16), plan.ts)
            op = plan.fill(g=gk, g_ld=gk.stride(1), mask=mask, s=v[2],
                           wb=weight_packs(w)[1],
                           gx=plan.alloc("gx", torch.bfloat16, g.device))
        self._launch("sg_tdnn_conv_bwd", g.device, *op.values())
        pad = same_pad(w.shape[2], dilation) if gamma is not None else 0
        return fold_reflected(op["gx"], pad) if pad else op["gx"]


tdnn_conv = _TdnnConv()
