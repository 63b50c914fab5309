"""DCNv2: the hand-written CUDA kernels and their plain PyTorch versions.

`deform_conv2d` keeps the JAX package's layout and contract
(centerpoly_tpu/models/deform_conv.py::deform_conv2d):

  x        (B, H, W, Cin)
  offsets  (B, H, W, 18)  tap-major interleaved (dy, dx), row-major taps
  masks    (B, H, W, 9)   already passed through sigmoid
  weights  (3, 3, Cin, Cout)
  bias     (Cout,)

The clamp is set by two keywords that exclude each other (both at once is
a ValueError):
  * neither given: the exact semantics of kernels/dcn_pallas.py;
  * `max_offset_y=R`: the `rowband:R` semantics of kernels/dcn_rowband.py,
    y-offsets clamped to [-R, R], x exact.  The clamp passes a y-offset
    gradient of 1 inside the band, 0.5 at exactly +-R and 0 beyond
    (jnp.clip's tie rule, dcn_rowband.py:458-465);
  * `max_offset=R`: the `halo:R` semantics of kernels/dcn_halo.py, both
    offset axes clamped to [-R, R].  Its offset gradients are those at the
    clamped offsets, zeroed on each component where |o| >= R, the exact
    bound included: the rule of the halo kernel's backward
    (dcn_halo.py:442-450).  The JAX oracle `deform_conv2d_halo_ref` and
    the JAX module's XLA fallback (what runs off the TPU) pass 0.5 of the
    one-sided derivative at exactly +-R instead (jnp.clip's tie rule).  The
    port follows the kernel on the card and in its plain CPU version alike,
    so the function does not depend on the device.
Samples outside the image read zero in every mode.

On a CUDA tensor the forward launches csrc/dcn_fwd.cu and the backward
csrc/dcn_bwd.cu (each built with nvcc for sm_90a at first use, bound
through a plain C interface) or raises; on a CPU tensor the forward is
`deform_conv2d_ref` and the backward is autograd through it
(`deform_conv2d_backward_ref`).  The kernels take f32 or bf16
activations and weights and accumulate in f32.  The forward contracts on
the tensor cores (bf16; f32 as 3xTF32, f32-accurate) and, where its tiles
do not cover the card's SMs, splits K into ranges (`fwd_plan`) whose f32
partial sums a second kernel adds in a fixed order: the output does not
change from run to run.  The backward takes its two products on the
tensor cores inside two gather kernels (`bwd_plan`) and splits dW over
pixel ranges the same way; only dx, a scatter by f32 atomics, may differ
in its last bits between runs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import nvcc

# dcn_fwd's tiles (csrc/dcn_fwd.cu): output pixels a block, bytes of one
# pixel's channels in a K chunk (64 bf16 or 32 f32 channels), and the
# output-channel tiles; dcn_bwd_weight (csrc/dcn_bwd.cu) uses the same
# pixel and output-channel tiles
FWD_TILE_PIXELS = 64
FWD_CHUNK_BYTES = 128
FWD_CHANNEL_TILES = (64, 128, 256)
# input channels of one dcn_bwd_weight block, either type
BWD_WEIGHT_CHANNELS = 64

# dcn_bwd_weight's grid is cut into pixel ranges, dcn_bwd_data's into tap
# ranges, until it holds this many blocks for each SM.  On the H100, a
# train step's weight kernel took 6.11 / 5.30 / 4.25 / 3.81 ms at 1 / 2 /
# 4 / 8 blocks an SM; 8 doubles the largest dW workspace (to ~71 MB).
# Without the tap ranges the data kernel took 7.44 ms, with them 6.40
# (PERF.md)
BWD_WAVES = 4

# kernel launches by kernel and clamp mode; only the CUDA branches count,
# so a run can show that its DCN nodes went through the kernels
launches = {"exact": 0, "rowband": 0, "halo": 0,
            "bwd_exact": 0, "bwd_rowband": 0, "bwd_halo": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# clamp mode -> the kernels' `clamp` argument (none / y / xy)
_CLAMP_CODE = {"exact": 0, "rowband": 1, "halo": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
_BWD_ARGS = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I, _I, _P]


def clamp_y_keep(oy: torch.Tensor, r: float) -> torch.Tensor:
    """d clip(oy, -r, r) / d oy under jnp.clip's tie rule: 1 inside the
    band, 0.5 at exactly +-r, 0 beyond (dcn_rowband.py:458-465)."""
    one = torch.ones_like(oy)
    half, zero = 0.5 * one, torch.zeros_like(oy)
    return (torch.where(oy > -r, one, torch.where(oy == -r, half, zero))
            * torch.where(oy < r, one, torch.where(oy == r, half, zero)))


class _ClampY(torch.autograd.Function):
    """Clamp only the y components ([..., 0::2]) to [-r, r], with the
    JAX package's gradient at the bound (not Tensor.clamp's 1)."""

    @staticmethod
    def forward(ctx, offsets, r):
        ctx.save_for_backward(offsets)
        ctx.r = r
        out = offsets.clone()
        out[..., 0::2] = torch.minimum(torch.maximum(
            offsets[..., 0::2], offsets.new_tensor(-r)), offsets.new_tensor(r))
        return out

    @staticmethod
    def backward(ctx, g):
        (offsets,) = ctx.saved_tensors
        g = g.clone()
        g[..., 0::2] *= clamp_y_keep(offsets[..., 0::2], ctx.r)
        return g, None


def clamp_y(offsets: torch.Tensor, r: float) -> torch.Tensor:
    """y-clamp of kernels/dcn_rowband.py::_clamp_y with its tie rule."""
    return _ClampY.apply(offsets, float(r))


def halo_keep(offsets: torch.Tensor, r: float) -> torch.Tensor:
    """The halo clamp's pass-through: 1 where -r < o < r, else 0, the
    exact bound included (dcn_halo.py:442-450)."""
    return ((offsets > -r) & (offsets < r)).to(offsets.dtype)


class _ClampXY(torch.autograd.Function):
    """Clamp every offset component to [-r, r], with the halo kernel's
    gradient: 0 wherever the clamp saturates, at exactly +-r too."""

    @staticmethod
    def forward(ctx, offsets, r):
        ctx.save_for_backward(offsets)
        ctx.r = r
        return torch.minimum(torch.maximum(offsets, offsets.new_tensor(-r)),
                             offsets.new_tensor(r))

    @staticmethod
    def backward(ctx, g):
        (offsets,) = ctx.saved_tensors
        return g * halo_keep(offsets, ctx.r), None


def clamp_xy(offsets: torch.Tensor, r: float) -> torch.Tensor:
    """Both-axes clamp of the `halo:R` mode with its tie rule."""
    return _ClampXY.apply(offsets, float(r))


def clamp_mode(max_offset_y: int | None = None,
               max_offset: int | None = None) -> tuple[str, float | None]:
    """The clamp keywords -> (mode, R): ("exact", None), ("rowband", R) or
    ("halo", R).  The two keywords exclude each other."""
    if max_offset_y is not None and max_offset is not None:
        raise ValueError("dcn: give max_offset_y (rowband) or max_offset "
                         "(halo), not both")
    if max_offset is not None:
        return "halo", float(max_offset)
    if max_offset_y is not None:
        return "rowband", float(max_offset_y)
    return "exact", None


def deform_conv2d_ref(x, offsets, masks, weights, bias=None,
                      max_offset_y: int | None = None,
                      max_offset: int | None = None) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward with the arithmetic of the JAX
    `deform_conv2d`, including the rounding of the fractions fy, fx to
    x.dtype; with `max_offset_y` the offsets are y-clamped first, with
    `max_offset` clamped on both axes.  Its autograd is the JAX package's:
    floor has no gradient, so a sample at an integer position
    differentiates on its floor cell (hat derivative -1 there, not 0); the
    clamps pass their gradients by their tie rules (module docstring)."""
    mode, r = clamp_mode(max_offset_y, max_offset)
    if mode == "rowband":
        offsets = clamp_y(offsets, r)
    elif mode == "halo":
        offsets = clamp_xy(offsets, r)
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    dev = x.device
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ky = torch.arange(-1, 2, dtype=torch.float32, device=dev).repeat_interleave(3)
    kx = torch.arange(-1, 2, dtype=torch.float32, device=dev).repeat(3)

    off = offsets.reshape(b, h, w, 9, 2).float()
    sy = gy[None, :, :, None] + ky + off[..., 0]
    sx = gx[None, :, :, None] + kx + off[..., 1]
    y0 = torch.floor(sy).detach()
    x0 = torch.floor(sx).detach()
    fy = (sy - y0)[..., None].to(x.dtype)
    fx = (sx - x0)[..., None].to(x.dtype)
    y0 = y0.long()
    x0 = x0.long()

    bidx = torch.arange(b, device=dev)[:, None, None, None] * (h * w)
    xf = x.reshape(b * h * w, cin)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = bidx + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = xf[idx]
        return torch.where(inb[..., None], v, 0)

    sampled = (tap(y0, x0) * (1 - fy) * (1 - fx)
               + tap(y0, x0 + 1) * (1 - fy) * fx
               + tap(y0 + 1, x0) * fy * (1 - fx)
               + tap(y0 + 1, x0 + 1) * fy * fx)
    sampled = sampled * masks[..., None]
    out = torch.einsum("bhwkc,kco->bhwo", sampled,
                       weights.reshape(9, cin, cout).to(sampled.dtype))
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def deform_conv2d_backward_ref(x, offsets, masks, weights, bias, g,
                               max_offset_y: int | None = None,
                               max_offset: int | None = None):
    """Plain backward: (dx, doffsets, dmasks, dweights, dbias) by autograd
    through `deform_conv2d_ref`, on any device."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, offsets, masks, weights, bias)]
        out = deform_conv2d_ref(*leaves, max_offset_y=max_offset_y,
                                max_offset=max_offset)
        return torch.autograd.grad(out, leaves, g)


class FwdPlan(NamedTuple):
    """How csrc/dcn_fwd.cu cuts one forward: a grid of m_tiles pixel tiles
    x n_tiles channel tiles of width bn x `splits` K ranges.  K runs over
    k_chunks chunks, tap-major: chunk kc is tap kc // (k_chunks // 9),
    channels ck * (kc % (k_chunks // 9)) onwards."""
    bn: int
    ck: int
    m_tiles: int
    n_tiles: int
    k_chunks: int
    splits: int

    def split_chunks(self, s: int) -> range:
        """The K chunks of split s (the kernel's own formula)."""
        return range(s * self.k_chunks // self.splits,
                     (s + 1) * self.k_chunks // self.splits)


def fwd_plan(npix: int, cin: int, cout: int, n_sm: int,
             dtype: torch.dtype = torch.bfloat16) -> FwdPlan:
    """The tiles and the split-K of dcn_fwd for B*H*W = npix pixels.  One
    split where the (pixel, channel) tiles cover the n_sm SMs; else enough
    splits that tiles x splits does, never more than there are K chunks.
    The splits' partial sums are reduced in a fixed order, so the result
    does not depend on the plan's timing, only on the plan."""
    ck = FWD_CHUNK_BYTES // dtype.itemsize
    bn = next((b for b in FWD_CHANNEL_TILES if cout <= b),
              FWD_CHANNEL_TILES[-1])
    m_tiles = -(-npix // FWD_TILE_PIXELS)
    n_tiles = -(-cout // bn)
    k_chunks = 9 * -(-cin // ck)
    tiles = m_tiles * n_tiles
    # an empty output (no tiles) launches nothing and needs no workspace
    splits = (1 if tiles == 0 or tiles >= n_sm
              else max(1, min(k_chunks, -(-n_sm // tiles))))
    return FwdPlan(bn, ck, m_tiles, n_tiles, k_chunks, splits)


class BwdPlan(NamedTuple):
    """How csrc/dcn_bwd.cu cuts one backward.  dcn_bwd_data: m_tiles pixel
    tiles x `data_splits` contiguous tap ranges.  dcn_bwd_weight: k_tiles
    (tap, BWD_WEIGHT_CHANNELS input channels) x n_tiles output-channel
    tiles of width bn x `splits` contiguous ranges of the m_tiles pixel
    tiles."""
    bn: int
    m_tiles: int
    n_tiles: int
    k_tiles: int
    splits: int
    data_splits: int

    def split_tiles(self, s: int) -> range:
        """The pixel tiles of dW split s (the kernel's own formula)."""
        return range(s * self.m_tiles // self.splits,
                     (s + 1) * self.m_tiles // self.splits)

    def data_taps(self, s: int) -> range:
        """The taps of dcn_bwd_data's split s (the kernel's own formula)."""
        return range(s * 9 // self.data_splits,
                     (s + 1) * 9 // self.data_splits)


def bwd_plan(npix: int, cin: int, cout: int, n_sm: int) -> BwdPlan:
    """The tiles and splits of dcn_bwd for B*H*W = npix pixels (the same
    for f32 and bf16, whose blocks differ only inside the kernels).  dW:
    one split where the (tap, input-, output-channel) tiles fill the card
    (BWD_WAVES blocks for each of the n_sm SMs); else enough pixel ranges
    that tiles x splits does, never more than there are pixel tiles; the
    partial sums are reduced in a fixed order.  dx, d offsets, d masks:
    the 9 taps cut into ranges where the pixel tiles alone do not fill the
    card the same way (each (pixel, tap) stays in one block)."""
    bn = next((b for b in FWD_CHANNEL_TILES if cout <= b),
              FWD_CHANNEL_TILES[-1])
    m_tiles = -(-npix // FWD_TILE_PIXELS)
    n_tiles = -(-cout // bn)
    k_tiles = 9 * -(-cin // BWD_WEIGHT_CHANNELS)
    tiles = k_tiles * n_tiles
    splits = (1 if m_tiles == 0 or tiles == 0 or tiles >= BWD_WAVES * n_sm
              else min(m_tiles, -(-BWD_WAVES * n_sm // tiles)))
    data_splits = (1 if m_tiles == 0 or m_tiles >= BWD_WAVES * n_sm
                   else min(9, -(-BWD_WAVES * n_sm // m_tiles)))
    return BwdPlan(bn, m_tiles, n_tiles, k_tiles, splits, data_splits)


def _check(x, offsets, masks, weights, bias, g=None):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dcn: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"dcn: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    want = {"offsets": (offsets, (b, h, w, 18), torch.float32),
            "masks": (masks, (b, h, w, 9), torch.float32),
            "weights": (weights, (3, 3, cin, cout), x.dtype),
            "bias": (bias, (cout,), x.dtype)}
    if g is not None:
        want["grad"] = (g, (b, h, w, cout), x.dtype)
    for name, (t, shape, dtype) in [("x", (x, tuple(x.shape), x.dtype)),
                                    *want.items()]:
        if t.device != x.device:
            raise ValueError(f"dcn: {name} on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"dcn: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"dcn: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dcn: {name} must be contiguous")


def _forward(x, offsets, masks, weights, bias, max_offset_y, max_offset):
    """The forward on x's device: the kernel on CUDA, the plain version on
    the CPU."""
    mode, r = clamp_mode(max_offset_y, max_offset)
    if x.device.type == "cpu":
        return deform_conv2d_ref(x, offsets, masks, weights, bias,
                                 max_offset_y, max_offset)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fwd: no kernel for device {x.device}")
    _check(x, offsets, masks, weights, bias)
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    npix = b * h * w
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    fwd = nvcc.load("dcn_fwd", "dcn_fwd", _FWD_ARGS)
    with torch.cuda.device(x.device):
        plan = fwd_plan(npix, cin, cout,
                        nvcc.sm_count(torch.cuda.current_device()), x.dtype)
        # the splits' f32 partial sums (stream-ordered: its memory is
        # reused only after the reduce has run)
        ws = (torch.empty((plan.splits, npix, cout), dtype=torch.float32,
                          device=x.device) if plan.splits > 1 else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(x.data_ptr(), offsets.data_ptr(), masks.data_ptr(),
                  weights.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), b, h, w, cin,
                  cout, _DTYPE_CODE[x.dtype], _CLAMP_CODE[mode],
                  r or 0.0, plan.bn, plan.splits, stream)
    if err != 0:
        raise RuntimeError(f"dcn_fwd launch failed: cudaError {err}")
    launches[mode] += 1
    return out


def deform_conv2d_backward(x, offsets, masks, weights, bias, g,
                           max_offset_y: int | None = None,
                           max_offset: int | None = None):
    """DCNv2 backward: (dx, doffsets, dmasks, dweights, dbias) for the
    cotangent g (B, H, W, Cout) of `deform_conv2d`; offsets are the raw
    (unclamped) ones.

    On CUDA, csrc/dcn_bwd.cu (`bwd_plan` cuts the work): `dcn_bwd_data`
    recomputes each tap's four bilinear corners at the clamped offsets,
    takes gk = g W_k^T (dcn_rowband.py:309, dcn_halo.py:385) on the tensor
    cores a chunk at a time in shared memory, and emits d offsets, d masks
    and dx by f32 atomics; `dcn_bwd_weight` takes dW_k = (m S_k)^T g
    (dcn_rowband.py:353-354, dcn_halo.py:388) on the tensor cores, split
    over pixel ranges into an f32 workspace that a third kernel adds in a
    fixed order.  No (npix, 9 Cin) buffer is made and no library GEMM is
    called.  db = sum g is a reduction here (dcn_rowband.py:355), and the
    clamp's pass-through scales the offset gradients: the y components by
    `clamp_y_keep` (rowband, :458-465), every component by `halo_keep`
    (halo, dcn_halo.py:442-450).  dx is summed by atomics, so its last bits
    may change from call to call; the other four are bit-equal."""
    mode, r = clamp_mode(max_offset_y, max_offset)
    if x.device.type == "cpu":
        return deform_conv2d_backward_ref(x, offsets, masks, weights, bias,
                                          g, max_offset_y, max_offset)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_bwd: no kernel for device {x.device}")
    _check(x, offsets, masks, weights, bias, g)
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    npix = b * h * w
    doff = torch.empty((b, h, w, 18), dtype=torch.float32, device=x.device)
    dmask = torch.empty((b, h, w, 9), dtype=torch.float32, device=x.device)
    dx = torch.zeros((b, h, w, cin), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(weights)
    bwd = nvcc.load("dcn_bwd", "dcn_bwd", _BWD_ARGS)
    with torch.cuda.device(x.device):
        plan = bwd_plan(npix, cin, cout,
                        nvcc.sm_count(torch.cuda.current_device()))
        # the pixel splits' f32 partial dW (stream-ordered: its memory is
        # reused only after the reduce has run)
        ws = (torch.empty((plan.splits, 9 * cin, cout), dtype=torch.float32,
                          device=x.device) if plan.splits > 1 else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = bwd(x.data_ptr(), offsets.data_ptr(), masks.data_ptr(),
                  weights.data_ptr(), g.data_ptr(), dx.data_ptr(),
                  doff.data_ptr(), dmask.data_ptr(), dw.data_ptr(),
                  None if ws is None else ws.data_ptr(), b, h, w,
                  cin, cout, _DTYPE_CODE[x.dtype], _CLAMP_CODE[mode],
                  r or 0.0, plan.data_splits, plan.bn, plan.splits,
                  stream)
    if err != 0:
        raise RuntimeError(f"dcn_bwd launch failed: cudaError {err}")
    launches[f"bwd_{mode}"] += 1
    if mode == "rowband":
        doff[..., 0::2] *= clamp_y_keep(offsets[..., 0::2], r)
    elif mode == "halo":
        doff *= halo_keep(offsets, r)
    db = g.reshape(npix, cout).float().sum(0)
    return dx.to(x.dtype), doff, dmask, dw, db.to(bias.dtype)


class _DeformConv2d(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  Saves
    the raw offsets and the clamp keywords: the kernels own the clamp and
    its tie rule."""

    @staticmethod
    def forward(ctx, x, offsets, masks, weights, bias, max_offset_y,
                max_offset):
        ctx.save_for_backward(x, offsets, masks, weights, bias)
        ctx.clamp = (max_offset_y, max_offset)
        return _forward(x, offsets, masks, weights, bias, max_offset_y,
                        max_offset)

    @staticmethod
    def backward(ctx, g):
        grads = deform_conv2d_backward(*ctx.saved_tensors, g.contiguous(),
                                       *ctx.clamp)
        return (*grads, None, None)


def deform_conv2d(x, offsets, masks, weights, bias=None,
                  max_offset_y: int | None = None,
                  max_offset: int | None = None) -> torch.Tensor:
    """DCNv2 forward (see the module docstring for the contract); when
    grad is enabled the result carries the backward of
    `deform_conv2d_backward`."""
    if bias is None:
        bias = torch.zeros(weights.shape[-1], dtype=x.dtype, device=x.device)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, offsets, masks, weights, bias)):
        return _DeformConv2d.apply(x, offsets, masks, weights, bias,
                                   max_offset_y, max_offset)
    return _forward(x, offsets, masks, weights, bias, max_offset_y,
                    max_offset)
