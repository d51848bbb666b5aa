"""Rotation / general-affine sampling without gathers.

The reference composites rotated elements through the GPU's hardware
bilinear sampler (`kernels.cl.swift:61` — any 4x4 transform, one texture
fetch per pixel).  The exact device path samples a rotated grid with
`jnp` 2-D gathers; this module is the gather-free alternative.  It
samples an affine map ``(x_s, y_s) = M @ (j, i) + c`` as a
three-pass cascade, each pass gather-free:

* **x-shear** ``I1(x, y) = src(x + u*y, y)`` — every source row shifted by
  a per-row real offset.  The integer part is applied by *binary
  shift-composition*: ceil(log2(range)) static circular rolls, each
  selected per-row by one bit of the row's shift (`jnp.roll` + `where`
  are plain fused XLA elementwise ops); the fractional part is one lerp
  of two adjacent taps.
* **separable scale** ``I2 = V @ I1 @ H`` — banded two-tap hat matrices
  as matmuls (`matscale.hat_matrix`, any real scale, Precision.HIGH: one
  TF32 pass on the H100, see matscale's precision note).
* **y-shear** ``I3(x, y) = I2(x, y + v*x)`` — the x-shear pass on the
  transpose.

with ``M = Shx(u) . diag(sx, sy) . Shy(v)`` (u = B/E, v = D/E,
sx = det/E, sy = E for M = [[A, B], [D, E]]).  When ``|E| < |B|`` the
source is transposed first so the divisor is always the larger cross
term; this keeps |u| <= 1 for pure rotations at any angle.

**Accuracy contract**: the cascade geometry is exact (the composed
affine equals M up to f64 rounding), but the *filter* is three chained
1-D lerps instead of one 2-D bilinear tap, so outputs differ from
`golden.bilinear_norm` by a content-dependent amount: <= 1-2 LSB on
smooth/natural content, up to ~10% of local contrast on per-pixel noise
(measured in tests/test_warp.py).  This is a documented approximation —
the mixer uses it for large rotated sources unless
``SWIFTVIDEO_EXACT_ROTATION`` asks for the exact gather path (PERF.md
times both at 1080p).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .matscale import hat_matrix

_MAX_SHIFT_RANGE = 1 << 13     # give up (fall back) past 8192-lane shears


def affine_from_packed(packed, h_out: int, w_out: int,
                       h_in: int, w_in: int):
    """Source-pixel sampling affine for output pixel (j, i):
    ``x_s = A j + B i + C``, ``y_s = D j + E i + F`` (f64).

    Mirrors golden._masks + bilinear_norm: ndc p = 2*(idx)/n - 1, chained
    transform/texture affines, then uv * n_in - 0.5."""
    p = np.asarray(packed, np.float64)
    # px = 2 j / w_out - 1 ; py = 2 i / h_out - 1
    # tx = [[p0, p1], [p2, p3]] @ (px, py) + (p4, p5)
    # uv = [[p6, p7], [p8, p9]] @ (tx_x, tx_y) + (p10, p11)
    t = np.array([[p[0], p[1]], [p[2], p[3]]])
    e = np.array([[p[6], p[7]], [p[8], p[9]]])
    m = e @ t
    c0 = e @ np.array([p[4], p[5]]) + np.array([p[10], p[11]])
    # compose with ndc scaling and uv->pixel scaling
    ndc = np.array([[2.0 / w_out, 0.0], [0.0, 2.0 / h_out]])
    mm = m @ ndc
    cc = c0 - m @ np.array([1.0, 1.0])
    sx = np.array([[w_in, 0.0], [0.0, h_in]])
    mm = sx @ mm
    cc = sx @ cc - 0.5
    return (mm[0, 0], mm[0, 1], cc[0],    # A, B, C
            mm[1, 0], mm[1, 1], cc[1])    # D, E, F


def _row_shift_sample(arr, offsets, out_w: int, xp=np):
    """out[i, m] = lerp(arr[i, k_i + m], arr[i, k_i + m + 1], g_i) with
    k_i = floor(offsets[i]), edge-clamped; offsets is a host ndarray."""
    offsets = np.asarray(offsets, np.float64)
    k = np.floor(offsets).astype(np.int64)
    g = (offsets - k).astype(np.float32)
    kmin = int(k.min())
    rel = (k - kmin).astype(np.int64)           # [H] in [0, R]
    r_max = int(rel.max())
    h, w = arr.shape
    # pad so window [kmin + m] for m in [0, out_w] and the +R shifts all
    # land inside: lanes [0, out_w + 1 + r_max) read source columns
    # [kmin, kmin + out_w + 1 + r_max)
    left = max(0, -kmin)
    right = max(0, kmin + out_w + 1 + r_max - w)
    if xp is np:
        p = np.pad(arr.astype(np.float32), ((0, 0), (left, right)),
                   mode="edge")
    else:
        import jax.numpy as jnp
        p = jnp.pad(arr.astype(jnp.float32), ((0, 0), (left, right)),
                    mode="edge")
    start = kmin + left                          # >= 0
    p = p[:, start:start + out_w + 1 + r_max]
    bits = max(1, r_max.bit_length()) if r_max else 0
    for b in range(bits):
        sel = ((rel >> b) & 1).astype(bool)[:, None]
        if xp is np:
            rolled = np.roll(p, -(1 << b), axis=1)
            p = np.where(sel, rolled, p)
        else:
            import jax.numpy as jnp
            rolled = jnp.roll(p, -(1 << b), axis=1)
            p = jnp.where(jnp.asarray(sel), rolled, p)
    t0 = p[:, :out_w]
    t1 = p[:, 1:out_w + 1]
    if xp is np:
        return t0 * (1.0 - g[:, None]) + t1 * g[:, None]
    import jax.numpy as jnp
    gj = jnp.asarray(g)[:, None]
    return t0 * (1.0 - gj) + t1 * gj


class WarpPlan:
    """Host geometry for one (affine, sizes) warp; apply with sample()."""

    def __init__(self, A, B, C, D, E, F, h_in, w_in, h_out, w_out):
        self.transposed = abs(B) > abs(E)
        if self.transposed:
            # sample the transposed source: swap roles of x_s/y_s
            A, B, C, D, E, F = D, E, F, A, B, C
            h_in, w_in = w_in, h_in
        if abs(E) < 1e-9:
            raise ValueError("degenerate affine")
        self.u = B / E
        self.v = D / E
        self.sy = E
        self.sx = A - B * D / E
        self.F = F
        self.c2y = F
        self.c2x = C - self.u * F
        self.h_in, self.w_in = h_in, w_in
        self.h_out, self.w_out = h_out, w_out

        # extents, outward from the output grid
        # I3 grid: x3 = j in [0, w_out), y3 = i in [0, h_out)
        v_span = self.v * (w_out - 1)
        y2lo = math.floor(min(0.0, v_span)) - 1
        y2hi = math.ceil((h_out - 1) + max(0.0, v_span)) + 2
        self.y2lo = y2lo
        self.h2 = y2hi - y2lo                    # I2 rows (y2 - y2lo)
        self.w2 = w_out                          # I2 cols = x2 = j
        # I1 grid: y rows needed by V: sy*y2 + c2y for y2 in [y2lo, y2hi)
        ys = [self.sy * y2lo + self.c2y, self.sy * (y2hi - 1) + self.c2y]
        y1lo = math.floor(min(ys)) - 1
        y1hi = math.ceil(max(ys)) + 2
        # clamp to source rows (V clamps taps to this grid's edges, which
        # replicates source edge rows exactly)
        self.y1lo = max(y1lo, 0)
        self.y1hi = min(max(y1hi, self.y1lo + 2), max(h_in, self.y1lo + 2))
        self.h1 = self.y1hi - self.y1lo
        # I1 cols: x = sx*x2 + c2x for x2 in [0, w_out).  Frame-1 x maps
        # to source x = x + u*y, so x only matters within the source span
        # widened by the shear reach |u|*H — clamp the extent there
        # (everything further reads pure edge replicas either way).
        uspan = abs(self.u) * max(self.h_in, 1)
        xs = [self.c2x, self.sx * (w_out - 1) + self.c2x]
        x1lo = max(math.floor(min(xs)) - 1,
                   math.floor(-2 - uspan))
        x1hi = min(math.ceil(max(xs)) + 2,
                   math.ceil(w_in + 2 + uspan))
        x1hi = max(x1hi, x1lo + 2)
        self.x1lo = x1lo
        self.w1 = x1hi - x1lo

        shear_range = (abs(self.u) * max(self.h1, 1)
                       + abs(self.v) * max(w_out, 1))
        if (self.w1 <= 0 or self.w1 > _MAX_SHIFT_RANGE
                or self.h2 > _MAX_SHIFT_RANGE
                or shear_range > _MAX_SHIFT_RANGE):
            raise ValueError("warp extents out of range")

    # P2 matrices + per-row offsets for the numpy path (lazy: the device
    # path builds its own bucket-padded variants)
    @property
    def vmat(self):
        if not hasattr(self, "_vmat"):
            self._vmat = hat_matrix(
                self.h2, self.h1, a=self.sy,
                b=self.sy * self.y2lo + self.c2y - self.y1lo)
        return self._vmat

    @property
    def hmat(self):
        if not hasattr(self, "_hmat"):
            self._hmat = hat_matrix(self.w2, self.w1, a=self.sx,
                                    b=self.c2x - self.x1lo, transpose=True)
        return self._hmat

    @property
    def p1_off(self):
        # row y of I1 (y = y1lo + r) reads src at x1lo + m + u*y
        return self.x1lo + self.u * (self.y1lo + np.arange(self.h1))

    @property
    def p3_off(self):
        # column x3 = j of the output reads I2 rows i + v*j - y2lo
        return self.v * np.arange(self.w_out) - self.y2lo

    def sample(self, src, xp=np):
        """Sample the plane: src [h_in, w_in] (u8/float) -> [h_out, w_out]
        f32 values in source units (caller scales /255)."""
        if self.transposed:
            src = src.T
        src = src[self.y1lo:self.y1hi]
        if src.shape[0] < self.h1:               # clamp shortfall: edge rows
            reps = self.h1 - src.shape[0]
            if xp is np:
                src = np.concatenate([src, np.repeat(src[-1:], reps, 0)], 0)
            else:
                import jax.numpy as jnp
                src = jnp.concatenate(
                    [src, jnp.repeat(src[-1:], reps, 0)], 0)
        i1 = _row_shift_sample(src, self.p1_off, self.w1, xp)
        if xp is np:
            i2 = self.vmat @ i1 @ self.hmat
        else:
            import jax
            import jax.numpy as jnp
            hi = jax.lax.Precision.HIGH
            i2 = jnp.dot(jnp.dot(jnp.asarray(self.vmat), i1, precision=hi),
                         jnp.asarray(self.hmat), precision=hi)
        i3t = _row_shift_sample(i2.T, self.p3_off, self.h_out, xp)
        return i3t.T


def plan_warp(packed, h_out: int, w_out: int, h_in: int,
              w_in: int) -> Optional[WarpPlan]:
    """Build a WarpPlan from composite uniforms, or None when the affine
    is degenerate / the shear extents are unreasonable."""
    try:
        A, B, C, D, E, F = affine_from_packed(packed, h_out, w_out,
                                              h_in, w_in)
        return WarpPlan(A, B, C, D, E, F, h_in, w_in, h_out, w_out)
    except ValueError:
        return None


# --- device path (bucketed jit: animated rotations must not recompile) ----

def _shift_bits(span: int) -> int:
    return max(int(span).bit_length(), 1)


from functools import lru_cache  # noqa: E402


@lru_cache(maxsize=32)
def _warp_program(h_srcT: int, w_srcT: int, h_out: int, w_out: int):
    """One jitted warp per (transposed-source-shape, out-shape) — every
    angle of an animated rotation reuses it.  Bucketed shapes:

    * H1B = h_srcT + 4 rows of I1 (vertical extent clamps to the source)
    * W1B = w_srcT + 4 + 2 I1 columns (horizontal extent clamps likewise)
    * H2B = h_out + w_out + 4 rows of I2 (y-shear worst case |v| <= 1)
    * pass-1 shift range <= H1B, pass-3 range <= H2B (|u|, |v| <= 1 by
      the transpose rule for pure rotations; plans exceeding a range
      raise at plan time and the caller falls back)

    Per-angle data rides in as traced inputs: hat matrices, per-row
    integer-shift bit masks and fracs, and window starts."""
    import jax
    import jax.numpy as jnp

    h1b = h_srcT + 4
    w1b = w_srcT + 2 * h1b + 8       # shear reach: |u| <= 1 per axis
    h2b = h_out + w_out + 4
    bits1 = _shift_bits(2 * h1b + 2)
    bits3 = _shift_bits(h2b + 2)
    pad1 = 2 * h1b + 4
    wp1 = pad1 + w_srcT + 2 * h1b + 4 + w1b + (1 << bits1) + 8
    wp3 = h2b + (1 << bits3) + 8
    hi = jax.lax.Precision.HIGH

    def shift_pass(p, start, rel, g, out_w, bits):
        """p [R, Wp]; per-row windows start+rel_r, frac g_r -> [R, out_w]."""
        rng = 1 << bits
        win = jax.lax.dynamic_slice(
            p, (0, start), (p.shape[0], out_w + 1 + rng))
        for b in range(bits):
            sel = ((rel >> b) & 1)[:, None] != 0
            win = jnp.where(sel, jnp.roll(win, -(1 << b), axis=1), win)
        gj = g[:, None]
        return win[:, :out_w] * (1.0 - gj) + win[:, 1:out_w + 1] * gj

    def run(srcT, u, v, sx, sy, c2x, c2y, x1lo, y2lo, h2_live, w1_live):
        """Everything per-angle is derived ON DEVICE from these scalars —
        shipping precomputed hat matrices (tens of MB) per frame would
        load the host link with every frame."""
        f32 = jnp.float32
        x1lo_f = x1lo.astype(f32)

        # pass-1 shift tables: row r of I1 = source row min(r, H-1)
        rows = jnp.minimum(jnp.arange(h1b), h_srcT - 1).astype(f32)
        off1 = x1lo_f + u * rows
        k1 = jnp.floor(off1)
        g1 = (off1 - k1).astype(f32)
        k1 = k1.astype(jnp.int32)
        kmin1 = jnp.min(k1)
        rel1 = k1 - kmin1
        start1 = pad1 + kmin1

        # pass-3 shift tables: column j reads I2 rows i + v*j - y2lo
        cols = jnp.arange(w_out).astype(f32)
        off3 = v * cols - y2lo.astype(f32)
        k3 = jnp.floor(off3)
        g3 = (off3 - k3).astype(f32)
        k3 = k3.astype(jnp.int32)
        kmin3 = jnp.min(k3)
        rel3 = k3 - kmin3
        start3 = 4 + kmin3

        # banded hat matrices built by one-hot comparison (no scatter)
        def hat(n_out, n_in, a, b, live_out, live_in):
            r = jnp.arange(n_out).astype(f32)
            x = jnp.clip(a * r + b, 0.0, (live_in - 1).astype(f32))
            k0 = jnp.floor(x)
            fr = (x - k0).astype(f32)
            k0 = k0.astype(jnp.int32)
            kk1 = jnp.minimum(k0 + 1, live_in - 1)
            c = jnp.arange(n_in, dtype=jnp.int32)[None, :]
            mask = (jnp.arange(n_out) < live_out)[:, None].astype(f32)
            return ((c == k0[:, None]) * (1.0 - fr)[:, None]
                    + (c == kk1[:, None]) * fr[:, None]) * mask

        vmat = hat(h2b, h1b, sy, sy * y2lo.astype(f32) + c2y,
                   h2_live, jnp.int32(h_srcT))
        hmat = hat(w_out, w1b, sx, c2x - x1lo_f,
                   jnp.int32(w_out), w1_live).T

        # pass 1: x-shear of source rows (bucket-padded to [h1b, wp1])
        f = srcT.astype(jnp.float32)
        f = jnp.pad(f, ((0, h1b - h_srcT), (0, 0)), mode="edge")
        f = jnp.pad(f, ((0, 0), (pad1, wp1 - w_srcT - pad1)),
                    mode="edge")
        i1 = shift_pass(f, start1, rel1, g1, w1b, bits1)    # [h1b, w1b]
        # pass 2: separable scale as two matmuls
        i2 = jnp.dot(jnp.dot(vmat, i1, precision=hi), hmat,
                     precision=hi)                          # [h2b, w_out]
        # pass 3: y-shear via the transpose
        t = i2.T                                            # [w_out, h2b]
        t = jnp.pad(t, ((0, 0), (4, wp3 - h2b - 4)), mode="edge")
        i3t = shift_pass(t, start3, rel3, g3, h_out, bits3)
        return i3t.T                                        # [h_out, w_out]

    meta = dict(h1b=h1b, w1b=w1b, h2b=h2b, bits1=bits1, bits3=bits3,
                wp1=wp1, wp3=wp3, pad1=pad1, pad3=4)
    return jax.jit(run), meta


def warp_device_args(plan: WarpPlan, h_srcT: int, w_srcT: int):
    """Per-angle scalar inputs for `_warp_program` — (run, args tuple).
    Raises ValueError when the plan exceeds the bucket (caller falls
    back to the exact gather path).  Only ~10 scalars cross the host
    link per frame; all tables are built on device."""
    run, m = _warp_program(h_srcT, w_srcT, plan.h_out, plan.w_out)
    if plan.h2 > m["h2b"] or plan.w1 > m["w1b"]:
        raise ValueError("warp extents exceed device bucket")

    # host-side range validation mirroring the device derivations
    rows = np.minimum(np.arange(m["h1b"]), h_srcT - 1)
    k1 = np.floor(plan.x1lo + plan.u * rows).astype(np.int64)
    if int(k1.max() - k1.min()) >= (1 << m["bits1"]):
        raise ValueError("pass-1 shift range exceeds bucket")
    start1 = m["pad1"] + int(k1.min())
    if start1 < 0 or start1 + m["w1b"] + (1 << m["bits1"]) + 1 > m["wp1"]:
        raise ValueError("pass-1 window outside bucket pad")
    k3 = np.floor(plan.v * np.arange(plan.w_out) - plan.y2lo).astype(np.int64)
    if int(k3.max() - k3.min()) >= (1 << m["bits3"]):
        raise ValueError("pass-3 shift range exceeds bucket")
    start3 = 4 + int(k3.min())
    if start3 < 0 or start3 + plan.h_out + (1 << m["bits3"]) + 1 > m["wp3"]:
        raise ValueError("pass-3 window outside bucket pad")

    f32 = np.float32
    args = (f32(plan.u), f32(plan.v), f32(plan.sx), f32(plan.sy),
            f32(plan.c2x), f32(plan.c2y), np.int32(plan.x1lo),
            np.int32(plan.y2lo), np.int32(min(plan.h2, m["h2b"])),
            np.int32(min(plan.w1, m["w1b"])))
    return run, args


def warp_sample_device(plan: WarpPlan, src):
    """Device warp sample: src [h_in, w_in] (u8/f32 device or host array)
    -> [h_out, w_out] f32 in source units.  Shapes are bucketed so every
    frame of an animated rotation hits the same compiled program."""
    import jax.numpy as jnp
    src = jnp.asarray(src)
    if plan.transposed:
        src = src.T
    run, args = warp_device_args(plan, int(src.shape[0]), int(src.shape[1]))
    return run(src, *args)
