"""Device composite path: jitted XLA programs over the shared spec math.

The device path runs golden.py's algorithm with ``jax.numpy``, jitted per
(output format, size, source-structure) — XLA fuses the whole clear +
N-source fold into a handful of kernels, with per-pixel bilinear gathers
straight from the device planes.  ``composite_tick`` is the one entry the
VideoMixer calls every tick.

Batching: ``composite_stack_batched`` vmaps the fold over a leading stream
axis — the multi-stream mixing wall builds on it (parallel.wall shards the
batch over a device mesh).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..media.pixel import (PixelFormat, packed422_to_planar,
                           planar_to_packed422)
from . import golden
from .uniforms import UNIFORM_WIDTH, ImageUniforms


@lru_cache(maxsize=256)
def _stack_program(out_fmt: PixelFormat, size: Tuple[int, int],
                   in_fmts: Tuple[PixelFormat, ...],
                   separable: Tuple[bool, ...], batched: bool):
    """Build + jit a clear-then-fold composite program.

    Source planes arrive as a flat tuple-of-tuples pytree; uniforms as one
    [N, UNIFORM_WIDTH] array indexed per source.  ``separable[i]`` selects
    the axis-split fast sampling path per source (static; re-traced only
    when a source's axis-alignment status changes).
    """

    def run(source_planes, uniforms):
        target = [jnp.asarray(p) for p in golden.clear_planes(out_fmt, size)]
        for i, in_fmt in enumerate(in_fmts):
            target = golden.apply_composite(target, out_fmt, source_planes[i],
                                            in_fmt, uniforms[i], xp=jnp,
                                            separable=separable[i])
        return tuple(target)

    if batched:
        return jax.jit(jax.vmap(run))
    return jax.jit(run)


_PACKED_422 = (PixelFormat.yuvs, PixelFormat.zvuy)


def composite_stack_device(out_fmt: PixelFormat, size: Tuple[int, int],
                           sources: Sequence[Tuple[Sequence, PixelFormat,
                                                   ImageUniforms]]):
    """Device equivalent of golden.composite_stack: clear + fold N z-sorted
    sources in one jitted program.  Returns a tuple of device arrays.

    Packed 4:2:2 (yuvs/zvuy) in/out normalizes through y422p around the
    planar fold, matching golden.composite_stack's oracle definition."""
    if out_fmt in _PACKED_422 or any(fmt in _PACKED_422
                                     for _, fmt, _ in sources):
        fold_fmt = (PixelFormat.y422p if out_fmt in _PACKED_422
                    else out_fmt)
        norm = []
        for planes, fmt, uni in sources:
            if fmt in _PACKED_422:
                planes = packed422_to_planar(jnp.asarray(planes[0]), fmt,
                                             xp=jnp)
                fmt = PixelFormat.y422p
            norm.append((planes, fmt, uni))
        out = composite_stack_device(fold_fmt, size, norm)
        if out_fmt in _PACKED_422:
            return (planar_to_packed422([jnp.asarray(p) for p in out],
                                        out_fmt, xp=jnp),)
        return out
    in_fmts = tuple(fmt for _, fmt, _ in sources)
    planes = tuple(tuple(jnp.asarray(p) for p in s) for s, _, _ in sources)
    packed = [golden._packed(u) for _, _, u in sources]
    separable = tuple(golden.is_axis_aligned(p) for p in packed)
    if sources:
        unis = jnp.stack([jnp.asarray(p) for p in packed])
    else:
        unis = jnp.zeros((0, UNIFORM_WIDTH), jnp.float32)
    program = _stack_program(out_fmt, size, in_fmts, separable, False)
    return program(planes, unis)


def composite_stack_batched(out_fmt: PixelFormat, size: Tuple[int, int],
                            in_fmts: Tuple[PixelFormat, ...],
                            source_planes, uniforms,
                            separable: bool = True):
    """Batched fold over a leading stream axis.

    ``source_planes``: per-source tuples of [B, ...plane] arrays;
    ``uniforms``: [B, N, UNIFORM_WIDTH].  Returns tuple of [B, ...] planes.
    """
    program = _stack_program(out_fmt, size, tuple(in_fmts),
                             tuple(separable for _ in in_fmts), True)
    return program(source_planes, uniforms)


# --- single-kernel entry (ComputeKernel emulation) -------------------------

@lru_cache(maxsize=256)
def _apply_program(out_fmt: PixelFormat, in_fmt: PixelFormat,
                   out_size: Tuple[int, int], in_size: Tuple[int, int],
                   separable: bool):
    def run(target_planes, source_planes, packed):
        return tuple(golden.apply_composite(list(target_planes), out_fmt,
                                            list(source_planes), in_fmt,
                                            packed, xp=jnp,
                                            separable=separable))
    return jax.jit(run)


def apply_composite_device(target_planes, out_fmt: PixelFormat,
                           source_planes, in_fmt: PixelFormat, uni):
    """One source composited over the target on device (one reference kernel
    launch, compute.cl.swift:264-344)."""
    t = tuple(jnp.asarray(p) for p in target_planes)
    s = tuple(jnp.asarray(p) for p in source_planes)
    out_size = (t[0].shape[1], t[0].shape[0])
    in_size = (s[0].shape[1], s[0].shape[0])
    packed = golden._packed(uni)
    program = _apply_program(out_fmt, in_fmt, out_size, in_size,
                             golden.is_axis_aligned(packed))
    return program(t, s, jnp.asarray(packed))


def clear_device(out_fmt: PixelFormat, size: Tuple[int, int]):
    return tuple(jnp.asarray(p) for p in golden.clear_planes(out_fmt, size))


# --- rotated sources: gather-free warp sampling ---------------------------

@lru_cache(maxsize=64)
def _warp_blend_program(out_fmt: PixelFormat, in_fmt: PixelFormat,
                        out_size: Tuple[int, int],
                        in_size: Tuple[int, int],
                        grids: Tuple[str, ...],
                        transposed: Tuple[bool, ...]):
    """Jitted fold step for one rotated source: warp-sample each needed
    plane grid (ops/warp.py cascade, angle-stable bucketed shapes), then
    run the exact mask/fill/blend algebra with the samples injected via
    golden.apply_composite's ``sampler`` hook.  One compiled program per
    (formats, sizes, pass-orientation) — every frame of an animated
    rotation reuses it; the per-angle hat matrices / shift tables arrive
    as traced arguments."""
    from .warp import _warp_program

    w_out, h_out = out_size
    w_in, h_in = in_size
    biplanar = in_fmt in (PixelFormat.nv12, PixelFormat.nv21)
    rgba_in = in_fmt in golden.RGBA_FAMILY

    def grid_out_shape(grid):
        return ((h_out, w_out) if grid in ("y", "rgba", "uv_full")
                else (h_out // 2, w_out // 2))

    def grid_in_shape(grid):
        if grid in ("y", "rgba", "rgba_half"):
            return (h_in, w_in)
        return (h_in // 2, w_in // 2)

    runs = {}
    for g, tr in zip(grids, transposed):
        hs, ws = grid_in_shape(g)
        if tr:
            hs, ws = ws, hs
        ho, wo = grid_out_shape(g)
        runs[g] = (_warp_program(hs, ws, ho, wo)[0], tr)

    def run(target_planes, source_planes, packed, warp_args):
        def one(grid, plane):
            prog, tr = runs[grid]
            p = plane.T if tr else plane
            return prog(p, *warp_args[grid]) * np.float32(1.0 / 255.0)

        def many(grid, planes):
            # one vmapped warp pass for all of a grid's channels (the
            # cascade is pure rolls + hat matmuls, so the channel axis
            # batches straight into the matmuls) — [C, Ho, Wo] -> [Ho, Wo, C]
            prog, tr = runs[grid]
            stacked = jnp.stack([p.T if tr else p for p in planes])
            out = jax.vmap(lambda q: prog(q, *warp_args[grid]))(stacked)
            return jnp.moveaxis(out, 0, -1) * np.float32(1.0 / 255.0)

        def sampler(grid):
            if grid in ("rgba", "rgba_half"):
                chans = many(grid, [source_planes[0][..., k]
                                    for k in range(4)])
                if in_fmt == PixelFormat.BGRA:
                    chans = chans[..., jnp.array([2, 1, 0, 3])]
                return chans
            if grid == "y":
                return one("y", source_planes[0])
            # chroma ("uv" at half grid / "uv_full" at the luma grid)
            if biplanar:
                cb, cr = source_planes[1][..., 0], source_planes[1][..., 1]
                if in_fmt == PixelFormat.nv21:
                    cb, cr = cr, cb
            else:
                cb, cr = source_planes[1], source_planes[2]
            return many(grid, [cb, cr])

        return tuple(golden.apply_composite(
            list(target_planes), out_fmt, list(source_planes), in_fmt,
            packed, xp=jnp, separable=False, sampler=sampler))

    return jax.jit(run)


def apply_composite_warp(target_planes, out_fmt: PixelFormat,
                         source_planes, in_fmt: PixelFormat, uni):
    """Composite one ROTATED source via the three-pass warp sampler
    (ops/warp.py): exact masks/blend, cascade-filtered samples
    (documented tolerance).  Returns new target planes, or None when the
    geometry is unsupported (caller uses the exact gather path)."""
    from .warp import plan_warp, warp_device_args

    packed = golden._packed(uni)
    t = tuple(jnp.asarray(p) for p in target_planes)
    s = tuple(jnp.asarray(p) for p in source_planes)
    h_out, w_out = (int(t[0].shape[0]), int(t[0].shape[1]))
    if in_fmt in golden.RGBA_FAMILY:
        h_in, w_in = int(s[0].shape[0]), int(s[0].shape[1])
        grids = (("rgba",) if out_fmt in golden.RGBA_FAMILY
                 else ("rgba", "rgba_half"))
    else:
        h_in, w_in = int(s[0].shape[0]), int(s[0].shape[1])
        grids = ("y", "uv_full") if out_fmt in golden.RGBA_FAMILY else \
            ("y", "uv")
    if h_in % 2 or w_in % 2 or h_out % 2 or w_out % 2:
        return None

    def grid_sizes(grid):
        # rgba_half: full-res rgba source sampled onto the chroma grid
        if grid in ("y", "rgba", "rgba_half"):
            gin = (h_in, w_in)
        else:
            gin = (h_in // 2, w_in // 2)
        gout = ((h_out, w_out) if grid in ("y", "rgba", "uv_full")
                else (h_out // 2, w_out // 2))
        return gin, gout

    warp_args = {}
    transposed = []
    try:
        for g in grids:
            (gih, giw), (goh, gow) = grid_sizes(g)
            plan = plan_warp(packed, goh, gow, gih, giw)
            if plan is None:
                return None
            hs, ws = (giw, gih) if plan.transposed else (gih, giw)
            _, args = warp_device_args(plan, hs, ws)
            warp_args[g] = args
            transposed.append(plan.transposed)
    except ValueError:
        return None

    program = _warp_blend_program(out_fmt, in_fmt, (w_out, h_out),
                                  (w_in, h_in), grids, tuple(transposed))
    return program(t, s, jnp.asarray(packed), warp_args)


# --- boxed composite: per-source output bounding boxes ---------------------

def _host_box_size(packed_np: np.ndarray, size: Tuple[int, int],
                   bucket_h: int = 64, bucket_w: int = 128) -> Tuple[int, int]:
    """Static (bh, bw) bucket for a source's writable output region (its
    border rect), from HOST uniform values.  Bucketing bounds retraces when
    elements animate."""
    w, h = size
    p = np.asarray(packed_np, np.float64)

    def axis_extent(a, t, full):
        if abs(a) < 1e-12:
            return 0.0, float(full)
        lo = (0.0 - t) / a
        hi = (1.0 - t) / a
        lo, hi = min(lo, hi), max(lo, hi)
        # ndc -> pixels
        return (lo + 1.0) / 2.0 * full, (hi + 1.0) / 2.0 * full

    x0, x1 = axis_extent(p[12], p[16], w)
    y0, y1 = axis_extent(p[15], p[17], h)
    bw = int(np.ceil(min(x1, w) - max(x0, 0))) + 4
    bh = int(np.ceil(min(y1, h) - max(y0, 0))) + 4
    bw = min(-(-max(bw, 2) // bucket_w) * bucket_w, w)
    bh = min(-(-max(bh, 2) // bucket_h) * bucket_h, h)
    # chroma slices need even dims
    return bh + (bh % 2), bw + (bw % 2)


def _box_offsets(packed, size: Tuple[int, int], bh: int, bw: int):
    """Traced (oy, ox), even, clipped so the (bh, bw) box stays in-bounds."""
    w, h = size
    eps = 1e-12
    ax = packed[12]
    tx = packed[16]
    ay = packed[15]
    ty = packed[17]
    x_lo = jnp.minimum((0.0 - tx) / (ax + eps), (1.0 - tx) / (ax + eps))
    y_lo = jnp.minimum((0.0 - ty) / (ay + eps), (1.0 - ty) / (ay + eps))
    ox = (x_lo + 1.0) / 2.0 * w - 1.0
    oy = (y_lo + 1.0) / 2.0 * h - 1.0
    ox = jnp.clip(jnp.floor(ox / 2.0) * 2.0, 0, max(w - bw, 0)).astype(jnp.int32)
    oy = jnp.clip(jnp.floor(oy / 2.0) * 2.0, 0, max(h - bh, 0)).astype(jnp.int32)
    return oy, ox


@lru_cache(maxsize=256)
def _stack_program_boxed(out_fmt: PixelFormat, size: Tuple[int, int],
                         in_fmts: Tuple[PixelFormat, ...],
                         boxes: Tuple[Tuple[int, int], ...]):
    """Clear-then-fold where each source composites only into its bounding
    box (dynamic_slice / dynamic_update_slice with static box sizes) —
    per-pass cost scales with element area, not canvas area.  Axis-aligned
    yuv-planar sources only."""
    w, h = size

    def run(source_planes, uniforms):
        target = [jnp.asarray(p) for p in golden.clear_planes(out_fmt, size)]
        for i, in_fmt in enumerate(in_fmts):
            bh, bw = boxes[i]
            oy, ox = _box_offsets(uniforms[i], size, bh, bw)
            cy, cx = oy // 2, ox // 2
            sliced = [
                jax.lax.dynamic_slice(target[0], (oy, ox), (bh, bw)),
                jax.lax.dynamic_slice(target[1], (cy, cx), (bh // 2, bw // 2)),
                jax.lax.dynamic_slice(target[2], (cy, cx), (bh // 2, bw // 2)),
            ]
            out = golden.apply_composite(
                sliced, out_fmt, source_planes[i], in_fmt, uniforms[i],
                xp=jnp, separable=True, origin=(oy, ox), full_size=(h, w))
            target = [
                jax.lax.dynamic_update_slice(target[0], out[0], (oy, ox)),
                jax.lax.dynamic_update_slice(target[1], out[1], (cy, cx)),
                jax.lax.dynamic_update_slice(target[2], out[2], (cy, cx)),
            ]
        return tuple(target)

    return jax.jit(run)


WARP_EXACT_BUDGET_PX = 16384   # <= ~128x128 elements sample exactly


def composite_stack_warp(out_fmt: PixelFormat, size: Tuple[int, int],
                         sources,
                         exact_budget_px: Optional[int] = None):
    """Sequential device fold for stacks containing rotated sources:
    axis-aligned sources take the separable path, rotated ones the
    gather-free warp sampler (apply_composite_warp) with its documented
    cascade-filter tolerance.

    Per-element policy (round 3; replaces env-var-only selection): a
    rotated element whose writable area is at most ``exact_budget_px``
    uses the exact gather sampler instead — small overlays get oracle
    bilinear at negligible cost, and only large surfaces pay the
    tolerance for the ~40x speedup.  The gather also runs whenever a
    warp plan is impossible."""
    if exact_budget_px is None:
        exact_budget_px = WARP_EXACT_BUDGET_PX
    target = clear_device(out_fmt, size)
    for planes, in_fmt, uni in sources:
        packed = golden._packed(uni)
        out = None
        if not golden.is_axis_aligned(packed):
            bh, bw = _host_box_size(packed, size, bucket_h=2, bucket_w=2)
            if bh * bw > exact_budget_px:
                out = apply_composite_warp(target, out_fmt, planes, in_fmt,
                                           packed)
        if out is None:
            out = apply_composite_device(target, out_fmt, planes, in_fmt,
                                         packed)
        target = out
    return list(target)


def composite_stack_boxed(out_fmt: PixelFormat, size: Tuple[int, int],
                          sources, exact_rotation: Optional[bool] = None):
    """Boxed device fold (axis-aligned planar-yuv sources).  Falls back to
    the warp fold for rotated stacks / composite_stack_device otherwise.

    ``exact_rotation``: rotated sources sample via the fast shear-cascade
    warp (documented filter tolerance, ops/warp.py) when False, the exact
    gather path when True; None defers to the ``SWIFTVIDEO_EXACT_ROTATION``
    env var (library callers get a programmatic opt-out — advisor, r2)."""
    from ..media.pixel import PixelFormat as PF
    if exact_rotation is None:
        exact_rotation = bool(os.environ.get("SWIFTVIDEO_EXACT_ROTATION"))
    packed = [golden._packed(u) for _, _, u in sources]
    if (sources and any(not golden.is_axis_aligned(p) for p in packed)
            and not exact_rotation):
        return composite_stack_warp(out_fmt, size, sources)
    ok = (out_fmt == PF.y420p
          and all(fmt == PF.y420p for _, fmt, _ in sources)
          and all(golden.is_axis_aligned(p) for p in packed))
    if not ok or not sources:
        return composite_stack_device(out_fmt, size, sources)
    boxes = tuple(_host_box_size(p, size) for p in packed)
    in_fmts = tuple(fmt for _, fmt, _ in sources)
    planes = tuple(tuple(jnp.asarray(p) for p in s) for s, _, _ in sources)
    unis = jnp.stack([jnp.asarray(p) for p in packed])
    program = _stack_program_boxed(out_fmt, size, in_fmts, boxes)
    return program(planes, unis)


# --- batched-sampling boxed composite --------------------------------------

def _rationalize(a: float, max_q: int = 6, tol: float = 1e-7):
    """Return (p, q) with a ~= p/q (q <= max_q, p >= 1), else None."""
    if not np.isfinite(a) or a <= 0:
        return None
    for q in range(1, max_q + 1):
        p = round(a * q)
        if p >= 1 and abs(a - p / q) <= tol * max(1.0, abs(a)):
            return int(p), int(q)
    return None


def _axis_scales(packed_np: np.ndarray, size: Tuple[int, int],
                 in_shape: Tuple[int, int]):
    """Host-side: texel step per output pixel along (y, x) for an
    axis-aligned source — the `A` in golden's separable coordinate chain
    x_j = A*j + c (see golden._masks / bilinear_norm)."""
    w, h = size
    hin, win = in_shape
    ax = 2.0 * win * float(packed_np[6]) * float(packed_np[0]) / w
    ay = 2.0 * hin * float(packed_np[9]) * float(packed_np[3]) / h
    return ay, ax


def _phase_info(packed_list, size: Tuple[int, int],
                in_shape: Tuple[int, int]):
    """Shared rational phase info ((py, qy), (px, qx)) when every source has
    the same rational axis scales, else None (gather path).

    The phased (strided-slice) algebra is NOT wired into the default
    device paths: each strided slice can lower to its own full-plane pass,
    so the 3-tap separable sampler may move several times the bytes of
    the gather path's fused sampling.  It is kept as a gather-free
    alternative that PERF.md times against the gather on the card."""
    infos = set()
    for p in packed_list:
        ay, ax = _axis_scales(np.asarray(p), size, in_shape)
        ry, rx = _rationalize(ay), _rationalize(ax)
        if ry is None or rx is None:
            return None
        infos.add((ry, rx))
    return infos.pop() if len(infos) == 1 else None


def _phased_axis_sample(plane, c, p: int, q: int, n_out: int, axis: int):
    """Gather-free rational-scale bilinear sampling along one axis.

    Samples ``plane`` at positions x_j = (p/q)*j + c for j in [0, n_out)
    (golden.bilinear_norm algebra: i0 = floor(x), lerp rows i0/i0+1 with
    clamp-to-edge).  Because the scale is rational, output index j = q*t + k
    hits source index floor(c) + m_k + p*t with a per-phase constant
    fractional weight — so sampling is q static-strided slices plus a
    3-tap hat-weighted sum (the hat spans floor boundaries), with the only
    dynamic quantity one dynamic_slice start.  No gathers.

    Positions outside [-0.5, S-0.5] return garbage-but-bounded values;
    callers mask those out (out-of-texture pixels never use samples).
    """
    import math

    S = plane.shape[axis]
    A = p / q
    nk = -(-n_out // q)
    m = [int(math.floor(A * k)) for k in range(q)]
    r = [A * k - m[k] for k in range(q)]
    R = max(m) + p * (nk - 1) + 3
    # Edge padding implements golden's clamp-to-edge for every index the
    # decomposition can touch: left pad P covers tiles starting up to a
    # full tile before the texture (any position with a valid sample has
    # floor(c) >= -P, so clamping M to [-P, S-1] only moves positions that
    # are fully out-of-texture and masked anyway); right pad R covers the
    # window for any clamped start.
    P = int(math.ceil(A * (n_out - 1))) + 2
    lead = jax.lax.slice_in_dim(plane, 0, 1, axis=axis)
    tail = jax.lax.slice_in_dim(plane, S - 1, S, axis=axis)
    reps_l = [1] * plane.ndim
    reps_l[axis] = P
    reps_r = [1] * plane.ndim
    reps_r[axis] = R
    padded = jnp.concatenate(
        [jnp.tile(lead, reps_l), plane, jnp.tile(tail, reps_r)], axis=axis)
    M = jnp.clip(jnp.floor(c), -P, S - 1)
    g = (c - jnp.floor(c)).astype(jnp.float32)
    region = jax.lax.dynamic_slice_in_dim(
        padded, M.astype(jnp.int32) + P, R, axis=axis)
    outs = []
    for k in range(q):
        pos = r[k] + g
        w0 = jnp.maximum(0.0, 1.0 - pos)
        w1 = 1.0 - jnp.abs(pos - 1.0)
        w2 = jnp.maximum(0.0, pos - 1.0)
        lim = p * (nk - 1) + 1
        s0 = jax.lax.slice_in_dim(region, m[k], m[k] + lim, stride=p, axis=axis)
        s1 = jax.lax.slice_in_dim(region, m[k] + 1, m[k] + 1 + lim, stride=p,
                                  axis=axis)
        s2 = jax.lax.slice_in_dim(region, m[k] + 2, m[k] + 2 + lim, stride=p,
                                  axis=axis)
        outs.append(w0 * s0 + w1 * s1 + w2 * s2)
    out = jnp.stack(outs, axis=axis + 1)
    shape = list(out.shape)
    shape[axis:axis + 2] = [nk * q]
    out = out.reshape(shape)
    return jax.lax.slice_in_dim(out, 0, n_out, axis=axis)


@lru_cache(maxsize=128)
def _stack_program_batched_boxed(size: Tuple[int, int], n_sources: int,
                                 box: Tuple[int, int],
                                 in_shape: Tuple[int, int],
                                 phases=None):
    """Two-phase fold for the uniform case (same-size axis-aligned planar-yuv
    sources, one shared box bucket):

    * phase A — **batched** bilinear sampling + csc of all sources into
      box-sized tiles via vmap (sampling is the expensive part; batching
      amortizes the per-op overhead ~15x, as the mixing wall demonstrates);
    * phase B — the z-order blend fold, sequential but purely elementwise
      on box-sized slices (dynamic_slice / blend / dynamic_update_slice).

    Parity-exact with golden.composite_stack.
    """
    w, h = size
    bh, bw = box
    hin, win = in_shape

    def offsets(uniforms):
        oys, oxs = [], []
        for i in range(n_sources):
            oy, ox = _box_offsets(uniforms[i], size, bh, bw)
            oys.append(oy)
            oxs.append(ox)
        return jnp.stack(oys), jnp.stack(oxs)

    def sample_tile(planes, packed, oy, ox, grid_shape, grid_origin_div,
                    full, want):
        gh, gw = grid_shape
        d = grid_origin_div
        if phases is not None:
            # gather-free rational-scale path: x_j = A*j + c along each
            # axis (same affine chain as golden._masks separable coords)
            (py_, qy_), (px_, qx_) = phases
            fh, fw = full

            def c0(origin, coeff, toff, ucoeff, uoff, fdim, pdim):
                s = origin.astype(jnp.float32) / np.float32(fdim)
                t = packed[coeff] * (s * 2.0 - 1.0) + packed[toff]
                return (packed[ucoeff] * t + packed[uoff]) * pdim - 0.5

            def sample_plane(pl):
                hin_g, win_g = pl.shape
                cy = c0(oy // d, 3, 5, 9, 11, fh, hin_g)
                cx = c0(ox // d, 0, 4, 6, 10, fw, win_g)
                rows = _phased_axis_sample(golden._to_f(pl, jnp), cy,
                                           py_, qy_, gh, 0)
                return _phased_axis_sample(rows, cx, px_, qx_, gw, 1)

            if want == "y":
                return sample_plane(planes[0])
            return jnp.stack([sample_plane(planes[1]),
                              sample_plane(planes[2])])
        m = golden._masks(packed, gh, gw, jnp, True,
                          (oy // d, ox // d), full)
        _, _, _, uv_x, uv_y = m
        if want == "y":
            return golden.bilinear_norm(golden._to_f(planes[0], jnp),
                                        uv_x, uv_y, jnp)
        cb = golden.bilinear_norm(golden._to_f(planes[1], jnp), uv_x, uv_y, jnp)
        cr = golden.bilinear_norm(golden._to_f(planes[2], jnp), uv_x, uv_y, jnp)
        return jnp.stack([cb, cr])

    def blend_plane(cur_u8, samp, packed, oy, ox, full, fill_chan, clamp_lo):
        # cur_u8/samp: [gh, gw] or [C, gh, gw] (chroma channels stacked so
        # both blend in one op pass); fill_chan broadcasts per channel
        gh, gw = cur_u8.shape[-2:]
        mb, mt, mu, _, _ = golden._masks(packed, gh, gw, jnp, True,
                                         (oy, ox), full)
        op = packed[22]
        a_fill = op * packed[21]
        cur = cur_u8.astype(jnp.float32) * (1.0 / 255.0)
        blended = cur * (1 - op) + samp * op
        filled = jnp.clip(cur * (1 - a_fill) + fill_chan * a_fill,
                          clamp_lo, 1.0)
        out = jnp.where(mb & mt & mu, blended, jnp.where(mb, filled, cur))
        return jnp.clip(jnp.rint(out * 255.0), 0, 255).astype(jnp.uint8)

    from .color import RGB2YUV

    def run(ys, us, vs, uniforms):
        # ys: [N, hin, win] u8 etc.; uniforms [N, UNIFORM_WIDTH]
        oys, oxs = offsets(uniforms)
        # phase A sampling.  Gather path: vmap across sources amortizes
        # per-op dispatch (ops are many and medium-sized).  Phased path:
        # unroll — vmapping dynamic_slice over per-source traced starts
        # would lower the region grab to a gather, destroying the whole
        # point of the gather-free formulation (measured 4.6x slower).
        if phases is not None:
            luma_tiles = jnp.stack([
                sample_tile((ys[i], us[i], vs[i]), uniforms[i], oys[i],
                            oxs[i], (bh, bw), 1, (h, w), "y")
                for i in range(n_sources)])
            chroma_tiles = jnp.stack([
                sample_tile((ys[i], us[i], vs[i]), uniforms[i], oys[i],
                            oxs[i], (bh // 2, bw // 2), 2,
                            (h // 2, w // 2), "uv")
                for i in range(n_sources)])
        else:
            luma_tiles = jax.vmap(
                lambda y, u, v, p, oy, ox: sample_tile(
                    (y, u, v), p, oy, ox, (bh, bw), 1, (h, w), "y")
            )(ys, us, vs, uniforms, oys, oxs)
            chroma_tiles = jax.vmap(
                lambda y, u, v, p, oy, ox: sample_tile(
                    (y, u, v), p, oy, ox, (bh // 2, bw // 2), 2,
                    (h // 2, w // 2), "uv")
            )(ys, us, vs, uniforms, oys, oxs)
        # phase B: sequential blend fold (chroma channels stacked: one
        # slice/blend/update per source instead of two)
        ty = jnp.zeros((h, w), jnp.uint8)
        tc = jnp.full((2, h // 2, w // 2), 128, jnp.uint8)
        for i in range(n_sources):
            oy, ox = oys[i], oxs[i]
            cy, cx = oy // 2, ox // 2
            fill = uniforms[i][18:22]
            fill_yuv = [RGB2YUV[ch, 0] * fill[0] + RGB2YUV[ch, 1] * fill[1]
                        + RGB2YUV[ch, 2] * fill[2] + RGB2YUV[ch, 3]
                        for ch in range(3)]
            sl = jax.lax.dynamic_slice(ty, (oy, ox), (bh, bw))
            o0 = blend_plane(sl, luma_tiles[i], uniforms[i], oy, ox,
                             (h, w), fill_yuv[0], 0.0)
            ty = jax.lax.dynamic_update_slice(ty, o0, (oy, ox))
            slc = jax.lax.dynamic_slice(tc, (0, cy, cx),
                                        (2, bh // 2, bw // 2))
            fill_c = jnp.stack([fill_yuv[1], fill_yuv[2]])[:, None, None]
            oc = blend_plane(slc, chroma_tiles[i], uniforms[i], cy, cx,
                             (h // 2, w // 2), fill_c, -1.0)
            tc = jax.lax.dynamic_update_slice(tc, oc, (0, cy, cx))
        return ty, tc[0], tc[1]

    return jax.jit(run)


@lru_cache(maxsize=32)
def _stack_program_frames(size: Tuple[int, int], n_sources: int,
                          box: Tuple[int, int], in_shape: Tuple[int, int],
                          phases=None):
    """Frame-batched composite: vmap the whole batched-boxed fold over a
    leading frame axis, with **uniforms shared across the batch** (a mixer
    emits many ticks of one scene layout — pixel data changes every tick,
    the layout doesn't).  Batching frames amortizes the per-op dispatch
    overhead that dominates single-frame composites on this stack, exactly
    as stream-batching does for the mixing wall.

    Inputs: ys/us/vs ``[B, N, h, w]`` u8, uniforms ``[N, UNIFORM_WIDTH]``.
    Returns per-frame planes ``([B,H,W], [B,H/2,W/2], [B,H/2,W/2])``.
    """
    base = _stack_program_batched_boxed(size, n_sources, box, in_shape,
                                        phases)
    return jax.jit(jax.vmap(base, in_axes=(0, 0, 0, None)))


def composite_frames_device(size: Tuple[int, int], ys, us, vs, uniforms):
    """Frame-batched uniform-case composite (see _stack_program_frames).

    Caller guarantees the batched-boxed preconditions: same-size
    axis-aligned planar-yuv sources.  ``uniforms`` is a [N, UNIFORM_WIDTH]
    array of packed uniforms shared by every frame in the batch.
    """
    packed = [np.asarray(uniforms[i]) for i in range(uniforms.shape[0])]
    boxes = [_host_box_size(p, size) for p in packed]
    box = (max(b[0] for b in boxes), max(b[1] for b in boxes))
    in_shape = tuple(ys.shape[-2:])
    program = _stack_program_frames(size, int(ys.shape[1]), box, in_shape)
    return program(ys, us, vs, jnp.asarray(uniforms))


def batched_boxed_program(size: Tuple[int, int], sources):
    """``(program, args)`` of the uniform-case fast fold — all sources the
    same shape, axis-aligned, planar-yuv, one shared (max) box bucket —
    or None when the stack is not uniform.  ``program(*args)`` returns
    the y420p target planes; the program is jitted and jittable."""
    from ..media.pixel import PixelFormat as PF
    packed = [golden._packed(u) for _, _, u in sources]
    shapes = {tuple(np.shape(s[0])) for s, _, _ in sources}
    ok = (sources and len(shapes) == 1
          and all(fmt == PF.y420p for _, fmt, _ in sources)
          and all(golden.is_axis_aligned(p) for p in packed))
    if not ok:
        return None
    boxes = [_host_box_size(p, size) for p in packed]
    box = (max(b[0] for b in boxes), max(b[1] for b in boxes))
    in_shape = next(iter(shapes))
    ys = jnp.stack([jnp.asarray(s[0]) for s, _, _ in sources])
    us = jnp.stack([jnp.asarray(s[1]) for s, _, _ in sources])
    vs = jnp.stack([jnp.asarray(s[2]) for s, _, _ in sources])
    unis = jnp.stack([jnp.asarray(p) for p in packed])
    program = _stack_program_batched_boxed(size, len(sources), box, in_shape)
    return program, (ys, us, vs, unis)


def composite_stack_batched_boxed(size: Tuple[int, int], sources):
    """Uniform-case fast fold (see ``batched_boxed_program``).  Falls back
    to composite_stack_boxed otherwise."""
    from ..media.pixel import PixelFormat as PF
    plan = batched_boxed_program(size, sources)
    if plan is None:
        return composite_stack_boxed(PF.y420p, size, sources)
    program, args = plan
    return program(*args)


def composite_tick(out_fmt: PixelFormat, size: Tuple[int, int], sources):
    """The mixer's per-tick composite: clear + z-ordered fold of
    ``sources`` into ``out_fmt`` at ``size``, as one jitted program.
    Uniform y420p stacks take the batched-sampling boxed fold; every other
    stack the boxed fold (which itself routes rotated, packed and rgba
    sources)."""
    if out_fmt == PixelFormat.y420p:
        return composite_stack_batched_boxed(size, sources)
    return composite_stack_boxed(out_fmt, size, sources)
