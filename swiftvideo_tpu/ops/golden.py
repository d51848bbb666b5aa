"""Composite kernel family: shared spec implementation (numpy oracle + the
gather-based device path).

This module is the **behavioral spec** for every ``img_<in>_<out>`` kernel:
a vectorized implementation of the per-pixel algorithm the reference runs on
GPU (kernels.cl.swift:47-532, with the manual bilinear math of
kernels.cuda.swift:66-114 as the sampler definition).  All functions are
written against an array namespace ``xp`` — ``numpy`` (the golden CPU
oracle) or ``jax.numpy`` (the jit-able device reference path) — so both
paths share identical math by construction.  Every device program is
validated against this at <=1 LSB max pixel error.

Algorithm per output pixel (x, y) on an output grid of size W x H:

1. ``out_uv = (x/W, y/H)``; ``normpos = out_uv * 2 - 1`` (texel corner, not
   center — reference quirk, kernels.cl.swift:72).
2. ``tx = transform_inv @ normpos`` — element-local coords in [0,1]^2.
3. ``border = border_inv @ normpos``.
4. ``uv = texture_inv @ tx`` — texture coords.
5. Bilinear-sample the source at normalized uv, clamp-to-edge
   (``u' = u*W - 0.5``, OpenCL CLK_FILTER_LINEAR semantics).
6. Blend per input family:
   * yuv-family input (kernels.cl.swift:186-255): inside border AND tx AND
     uv -> ``out = cur*(1-op) + sample*op``; inside border otherwise -> fill
     blend with ``a = op*fill.a`` (fill rgb csc'd as a homogeneous vector);
     outside border -> no write.
   * rgba-family input (kernels.cl.swift:267-532): inside border AND tx ->
     start from the fill blend **with rgb premultiplied by a before csc**
     (reference quirk), then where uv inside, blend the sample with
     ``a = sample.a * op`` (rgb also premultiplied before csc); outside
     tx -> no write.
7. Chroma planes run the identical algorithm on the half-resolution grid
   (the reference's even-pixel ``handleChroma`` rule lands exactly on the
   half-res grid).
8. u8 conversion: read = v/255; write = clip(rint(v*255), 0, 255).

Uniforms arrive packed as a ``[UNIFORM_WIDTH]`` f32 vector
(ops.uniforms.ImageUniforms.pack) so the same entry points serve traced jax
values.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..media.pixel import PixelFormat
from .color import RGB2YUV, YUV2RGB
from .uniforms import ImageUniforms

_YUV_PLANAR = (PixelFormat.y420p, PixelFormat.y422p, PixelFormat.y444p)
_YUV_BIPLANAR = (PixelFormat.nv12, PixelFormat.nv21)
_RGBA = (PixelFormat.RGBA, PixelFormat.BGRA)
YUV_FAMILY = _YUV_PLANAR + _YUV_BIPLANAR
RGBA_FAMILY = _RGBA


def _packed(uni) -> np.ndarray:
    return uni.pack() if isinstance(uni, ImageUniforms) else uni


# --- sampling -------------------------------------------------------------

def bilinear_norm(plane, u, v, xp=np):
    """OpenCL-style normalized bilinear sample with clamp-to-edge.

    ``plane``: [H, W] or [H, W, C] float; ``u``/``v``: arrays of normalized
    coords.  Returns samples of shape ``broadcast(u, v).shape (+ [C])``.

    When the coords are **separable** (``u`` shaped [1, W], ``v`` shaped
    [H, 1] — the axis-aligned transform case), sampling runs as a row
    gather + lerp followed by a column gather + lerp instead of four full
    2-D gathers: each axis's indices are computed once per row or column,
    and the arithmetic is identical.
    """
    h, w = plane.shape[:2]
    separable = (getattr(u, "ndim", 0) == 2 and u.shape[0] == 1
                 and getattr(v, "ndim", 0) == 2 and v.shape[1] == 1)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = xp.floor(x)
    y0 = xp.floor(y)
    fx = (x - x0).astype(xp.float32)
    fy = (y - y0).astype(xp.float32)
    xi0 = xp.clip(x0, 0, w - 1).astype(xp.int32)
    xi1 = xp.clip(x0 + 1, 0, w - 1).astype(xp.int32)
    yi0 = xp.clip(y0, 0, h - 1).astype(xp.int32)
    yi1 = xp.clip(y0 + 1, 0, h - 1).astype(xp.int32)

    if separable:
        ry0 = yi0[:, 0]
        ry1 = yi1[:, 0]
        cy = fy  # [H, 1]
        cx = fx  # [1, W]
        if plane.ndim == 3:
            cy = cy[..., None]
            cx = cx[..., None]
        rows = plane[ry0] * (1.0 - cy) + plane[ry1] * cy  # [H, Win(,C)]
        cols0 = rows[:, xi0[0, :]]
        cols1 = rows[:, xi1[0, :]]
        return (cols0 * (1.0 - cx) + cols1 * cx).astype(xp.float32)

    if plane.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    p00 = plane[yi0, xi0]
    p01 = plane[yi0, xi1]
    p10 = plane[yi1, xi0]
    p11 = plane[yi1, xi1]
    top = p00 * (1.0 - fx) + p01 * fx
    bot = p10 * (1.0 - fx) + p11 * fx
    return (top * (1.0 - fy) + bot * fy).astype(xp.float32)


def _to_f(plane, xp=np):
    return plane.astype(xp.float32) / 255.0


def _to_u8(plane, xp=np):
    return xp.clip(xp.rint(plane * 255.0), 0, 255).astype(xp.uint8)


def _grid_ndc(h: int, w: int, xp=np):
    """normpos (px, py) for every pixel of an h x w grid."""
    ys = xp.arange(h, dtype=xp.float32)[:, None] / np.float32(h)
    xs = xp.arange(w, dtype=xp.float32)[None, :] / np.float32(w)
    px = xp.broadcast_to(xs * 2.0 - 1.0, (h, w))
    py = xp.broadcast_to(ys * 2.0 - 1.0, (h, w))
    return px, py


def _affine(coeffs, x, y):
    """Apply a packed 2D affine [a, b, c, d, tx, ty]."""
    return (coeffs[0] * x + coeffs[1] * y + coeffs[4],
            coeffs[2] * x + coeffs[3] * y + coeffs[5])


def _inside(x, y):
    return (x >= 0.0) & (x <= 1.0) & (y >= 0.0) & (y <= 1.0)


def _masks(packed, h: int, w: int, xp=np, separable: bool = False,
           origin=None, full_size=None):
    """Border / element / texture masks + texture coords.

    ``separable=True`` (axis-aligned transforms: the b/c affine cross terms
    are zero) keeps coordinates as [H,1] / [1,W] vectors so downstream
    sampling can use the fast axis-split gather path and masks broadcast
    as outer products.  ``origin``/``full_size`` evaluate a (h, w) window at
    pixel offset origin=(oy, ox) of a full_size=(H, W) grid — the boxed
    composite path (offsets may be traced)."""
    if separable:
        oy, ox = (0, 0) if origin is None else origin
        fh, fw = (h, w) if full_size is None else full_size
        ys = (xp.arange(h, dtype=xp.float32)[:, None] + oy) / np.float32(fh)
        xs = (xp.arange(w, dtype=xp.float32)[None, :] + ox) / np.float32(fw)
        px = xs * 2.0 - 1.0  # [1, W]
        py = ys * 2.0 - 1.0  # [H, 1]
        tx_x = packed[0] * px + packed[4]
        tx_y = packed[3] * py + packed[5]
        uv_x = packed[6] * tx_x + packed[10]
        uv_y = packed[9] * tx_y + packed[11]
        bd_x = packed[12] * px + packed[16]
        bd_y = packed[15] * py + packed[17]
    else:
        px, py = _grid_ndc(h, w, xp)
        tx_x, tx_y = _affine(packed[0:6], px, py)
        uv_x, uv_y = _affine(packed[6:12], tx_x, tx_y)
        bd_x, bd_y = _affine(packed[12:18], px, py)
    return (_inside(bd_x, bd_y), _inside(tx_x, tx_y), _inside(uv_x, uv_y),
            uv_x, uv_y)


def is_axis_aligned(packed: np.ndarray, eps: float = 1e-7) -> bool:
    """True when all three affines have no cross terms (no rotation), so the
    separable fast path is exact."""
    p = np.asarray(packed)
    return bool(abs(p[1]) < eps and abs(p[2]) < eps
                and abs(p[7]) < eps and abs(p[8]) < eps
                and abs(p[13]) < eps and abs(p[14]) < eps)


# --- clear (kernels.cl.swift:38-46, 174-185, 257-265) ---------------------

def clear_planes(fmt: PixelFormat, size: Tuple[int, int]) -> List[np.ndarray]:
    """Cleared target: luma 0, chroma 0.5 (=128), rgba (0,0,0,1)."""
    from ..media.pixel import allocate_planes
    planes = allocate_planes(fmt, size)
    if fmt in _YUV_PLANAR:
        planes[1][:] = 128
        planes[2][:] = 128
    elif fmt in _YUV_BIPLANAR:
        planes[1][:] = 128
    elif fmt in _RGBA:
        planes[0][..., 3] = 255
    return planes


# --- source color accessors ----------------------------------------------

def _sample_rgba(source_planes, in_fmt, u, v, xp=np):
    rgba = bilinear_norm(_to_f(source_planes[0], xp), u, v, xp)
    if in_fmt == PixelFormat.BGRA:
        rgba = rgba[..., [2, 1, 0, 3]]
    return rgba


def _sample_yuv(source_planes, in_fmt, u, v, want: str, xp=np):
    if want == "y":
        return bilinear_norm(_to_f(source_planes[0], xp), u, v, xp)
    if in_fmt in _YUV_PLANAR:
        cb = bilinear_norm(_to_f(source_planes[1], xp), u, v, xp)
        cr = bilinear_norm(_to_f(source_planes[2], xp), u, v, xp)
        return xp.stack([cb, cr], axis=-1)
    uv2 = bilinear_norm(_to_f(source_planes[1], xp), u, v, xp)
    if in_fmt == PixelFormat.nv21:
        uv2 = uv2[..., ::-1]
    return uv2


def _csc_yuv(rgb_premul, xp=np):
    """RGB2YUV rows applied to homogeneous [r,g,b,1]. [..., 3] -> [..., 3]."""
    m = RGB2YUV
    return xp.stack(
        [m[i, 0] * rgb_premul[..., 0] + m[i, 1] * rgb_premul[..., 1]
         + m[i, 2] * rgb_premul[..., 2] + m[i, 3] for i in range(3)], axis=-1)


def _csc_rgb(yuv, xp=np):
    m = YUV2RGB
    return xp.stack(
        [m[i, 0] * yuv[..., 0] + m[i, 1] * yuv[..., 1]
         + m[i, 2] * yuv[..., 2] + m[i, 3] for i in range(3)], axis=-1)


# --- the composite op -----------------------------------------------------

def apply_composite(target_planes: Sequence, out_fmt: PixelFormat,
                    source_planes: Sequence, in_fmt: PixelFormat,
                    uni, xp=np, separable: bool = False,
                    origin=None, full_size=None, sampler=None) -> List:
    """One source composited over the current target (one reference kernel
    launch, compute.cl.swift:264-344).  Returns new target planes (u8).

    ``separable=True`` selects the axis-split sampling path — exact for
    axis-aligned transforms (see is_axis_aligned).

    ``sampler``: optional override for texture fetches — a callable
    ``sampler(grid) -> array`` with grid in {"y", "uv", "rgba"} returning
    normalized samples at the target grid's resolution (the gather-free
    warp path for rotated sources, ops/warp.py).  Masks, fill, and blend
    stay on the exact path regardless."""
    packed = _packed(uni)
    c_origin = None if origin is None else (origin[0] // 2, origin[1] // 2)
    c_full = None if full_size is None else (full_size[0] // 2,
                                             full_size[1] // 2)
    if out_fmt in _RGBA:
        return [_composite_rgba_out(target_planes[0], out_fmt,
                                    source_planes, in_fmt, packed, xp,
                                    separable, origin, full_size, sampler)]
    luma = _composite_yuv_grid(target_planes[0], None, out_fmt,
                               source_planes, in_fmt, packed, "luma", xp,
                               separable, origin, full_size, sampler)
    if out_fmt in _YUV_PLANAR:
        cb, cr = _composite_yuv_grid(target_planes[1], target_planes[2],
                                     out_fmt, source_planes, in_fmt, packed,
                                     "chroma", xp, separable, c_origin,
                                     c_full, sampler)
        return [luma, cb, cr]
    chroma = _composite_yuv_grid(target_planes[1], None, out_fmt,
                                 source_planes, in_fmt, packed, "chroma", xp,
                                 separable, c_origin, c_full, sampler)
    return [luma, chroma]


def _composite_yuv_grid(cur0, cur1, out_fmt, source_planes, in_fmt, packed,
                        grid: str, xp=np, separable: bool = False,
                        origin=None, full_size=None, sampler=None):
    h, w = cur0.shape[:2]
    m_border, m_tx, m_uv, uv_x, uv_y = _masks(packed, h, w, xp, separable,
                                              origin, full_size)
    op = packed[22]
    fill = packed[18:22]

    if in_fmt in YUV_FAMILY:
        # family A: direct yuv blend (kernels.cl.swift:186-255)
        fill_yuv = _csc_yuv(fill[None, :3], xp)[0]
        a_fill = op * fill[3]
        if grid == "luma":
            cur = _to_f(cur0, xp)
            sample = (sampler("y") if sampler is not None else
                      _sample_yuv(source_planes, in_fmt, uv_x, uv_y, "y", xp))
            blended = cur * (1 - op) + sample * op
            filled = xp.clip(cur * (1 - a_fill) + fill_yuv[0] * a_fill, 0.0, 1.0)
            out = xp.where(m_border & m_tx & m_uv, blended,
                           xp.where(m_border, filled, cur))
            return _to_u8(out, xp)
        sample_uv = (sampler("uv") if sampler is not None else
                     _sample_yuv(source_planes, in_fmt, uv_x, uv_y, "uv", xp))
        curs = ([_to_f(cur0, xp), _to_f(cur1, xp)] if cur1 is not None
                else [_to_f(cur0[..., 0], xp), _to_f(cur0[..., 1], xp)])
        # biplanar target channel order: nv12 = cbcr, nv21 = crcb
        chan = (1, 0) if out_fmt == PixelFormat.nv21 else (0, 1)
        outs = []
        for ch in range(2):
            cur = curs[ch]
            blended = cur * (1 - op) + sample_uv[..., chan[ch]] * op
            filled = xp.clip(cur * (1 - a_fill)
                             + fill_yuv[1 + chan[ch]] * a_fill,
                             -1.0, 1.0)
            outs.append(xp.where(m_border & m_tx & m_uv, blended,
                                 xp.where(m_border, filled, cur)))
        if cur1 is not None:
            return [_to_u8(outs[0], xp), _to_u8(outs[1], xp)]
        return _to_u8(xp.stack(outs, axis=-1), xp)

    # family B: rgba input (kernels.cl.swift:267-532)
    a_fill = op * fill[3]
    fill_yuv = _csc_yuv(fill[None, :3] * a_fill, xp)[0]
    rgba = (sampler("rgba" if grid == "luma" else "rgba_half")
            if sampler is not None else
            _sample_rgba(source_planes, in_fmt, uv_x, uv_y, xp))
    a_s = rgba[..., 3] * op
    yuv_s = _csc_yuv(rgba[..., :3] * a_s[..., None], xp)
    write_mask = m_border & m_tx

    def blend_channel(cur, ch, clamp_lo):
        res = cur * (1 - a_fill) + fill_yuv[ch] * a_fill
        if clamp_lo is not None:
            res = xp.clip(res, clamp_lo, 1.0)
        res = xp.where(m_uv, res * (1 - a_s) + yuv_s[..., ch] * a_s, res)
        return xp.where(write_mask, res, cur)

    if grid == "luma":
        return _to_u8(blend_channel(_to_f(cur0, xp), 0, None), xp)
    if cur1 is not None:
        return [_to_u8(blend_channel(_to_f(cur0, xp), 1, -1.0), xp),
                _to_u8(blend_channel(_to_f(cur1, xp), 2, -1.0), xp)]
    c0, c1 = (2, 1) if out_fmt == PixelFormat.nv21 else (1, 2)
    return _to_u8(xp.stack(
        [blend_channel(_to_f(cur0[..., 0], xp), c0, -1.0),
         blend_channel(_to_f(cur0[..., 1], xp), c1, -1.0)], axis=-1), xp)


def _composite_rgba_out(cur, out_fmt, source_planes, in_fmt, packed, xp=np,
                        separable: bool = False, origin=None,
                        full_size=None, sampler=None):
    """rgba-family output grid: blit blend (kernels.metal img_bgra_bgra),
    extended to yuv inputs via YUV2RGB (the y420p->RGBA conversion config)."""
    h, w = cur.shape[:2]
    m_border, m_tx, m_uv, uv_x, uv_y = _masks(packed, h, w, xp, separable,
                                              origin, full_size)
    op = packed[22]
    fill = packed[18:22]
    cur_f = _to_f(cur, xp)
    swz = [2, 1, 0, 3] if out_fmt == PixelFormat.BGRA else [0, 1, 2, 3]
    cur_rgba = cur_f[..., swz]

    if in_fmt in RGBA_FAMILY:
        rgba = (sampler("rgba") if sampler is not None else
                _sample_rgba(source_planes, in_fmt, uv_x, uv_y, xp))
        alpha = rgba[..., 3:4] * op
        ones = xp.ones_like(rgba[..., 3:4])
        new = xp.concatenate([rgba[..., :3], ones], axis=-1)
    else:
        y = (sampler("y") if sampler is not None else
             _sample_yuv(source_planes, in_fmt, uv_x, uv_y, "y", xp))
        uv2 = (sampler("uv_full") if sampler is not None else
               _sample_yuv(source_planes, in_fmt, uv_x, uv_y, "uv", xp))
        rgb = _csc_rgb(xp.stack([y, uv2[..., 0], uv2[..., 1]], axis=-1), xp)
        alpha = xp.broadcast_to(op, y.shape)[..., None]
        new = xp.concatenate([rgb, xp.ones_like(y[..., None])], axis=-1)

    a_fill = op * fill[3]
    fill_rgba = xp.stack([fill[0], fill[1], fill[2], fill[3] * 0 + 1.0])
    blended = cur_rgba * (1 - alpha) + new * alpha
    filled = xp.clip(cur_rgba * (1 - a_fill) + fill_rgba * a_fill, 0.0, 1.0)
    out = xp.where((m_border & m_tx & m_uv)[..., None], blended,
                   xp.where(m_border[..., None], filled, cur_rgba))
    return _to_u8(out[..., swz], xp)


def composite_stack(out_fmt: PixelFormat, size: Tuple[int, int],
                    sources, xp=np) -> List:
    """Clear + fold N z-sorted sources (mix.video.swift:116-125 semantics):
    ``sources`` is a sequence of (planes, in_fmt, uniforms).

    Packed 4:2:2 (yuvs/zvuy) in/out normalizes through y422p planes —
    the reference had no packed-422 kernels at all (kernel matrix, SURVEY
    §2.3); this defines the oracle for the beyond-parity coverage."""
    from ..media.pixel import packed422_to_planar, planar_to_packed422
    packed_out = out_fmt in (PixelFormat.yuvs, PixelFormat.zvuy)
    fold_fmt = PixelFormat.y422p if packed_out else out_fmt
    norm = []
    for planes, in_fmt, uni in sources:
        if in_fmt in (PixelFormat.yuvs, PixelFormat.zvuy):
            planes = packed422_to_planar(xp.asarray(planes[0]), in_fmt, xp)
            in_fmt = PixelFormat.y422p
        norm.append((planes, in_fmt, uni))
    target = clear_planes(fold_fmt, size)
    if xp is not np:
        target = [xp.asarray(p) for p in target]
    for planes, in_fmt, uni in norm:
        target = apply_composite(target, fold_fmt, planes, in_fmt, uni, xp)
    if packed_out:
        # stays on device for xp=jnp (the old np.asarray round-trip broke
        # the device-array contract for packed outputs)
        return [planar_to_packed422(target, out_fmt, xp)]
    return target
