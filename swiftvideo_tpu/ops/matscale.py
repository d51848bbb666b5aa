"""Bilinear scale/convert as banded matmuls — the matrix unit is the sampler.

``out = V @ X @ H`` where ``V`` [oh, ih] and ``H`` [iw, ow] are
host-precomputed hat-function (two-tap bilinear) matrices and ``X`` is the
source plane.  This expresses ANY rational or irrational axis-aligned
scale — including the transcode ladder's 2:3 / 4:9 verticals and the
64-stream wall's 1080->136 (135:17) tiles — as two dense matmuls with
no gathers and no dynamic slices.

Precision: matmuls run at ``jax.lax.Precision.HIGH``, which on the H100
is one TF32 pass (10-bit mantissa; a 512x512 f32 product measured 2.9e-4
relative error, the same as the default precision).  Pixel values up to
255 are exact in TF32.  Each hat row has two taps summing to 1, each
rounded by at most 2^-12 relative, so the first pass errs by at most
255 * 2 * 2^-12 = 0.125; the second pass adds the rounding of its
inputs (<= 0.0625) and of its taps (<= 0.125).  The result stays within
~0.31 of the f32 oracle before ``rint``, inside the <=1 LSB contract
(tests/test_matscale.py; checked at 1080p on the card by chip_smoke.py).

Semantics parity: taps are clamp-to-edge exactly like
``golden.bilinear_norm`` (kernels.cuda.swift:66-114 is the reference's
manual-sampling twin); geometry comes from ``_plane_params_np``, the f32
affine algebra of golden's separable coordinate chain, so a plan built
from composite uniforms samples pixel-identically to the oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import golden


def _plane_params_np(packed: np.ndarray, h_out: int, w_out: int,
                     h_in: int, w_in: int) -> np.ndarray:
    """Per-plane affine scalars of a packed uniform vector, in f32:
    ``[ay, by, ax, bx]`` map output pixel (r, c) to source texel
    (ay*r + by, ax*c + bx); the next four map it to texture space and
    the last four to border space (golden._masks' separable chain)."""
    p = np.asarray(packed, np.float32)
    t0, t3, t4, t5 = p[0], p[3], p[4], p[5]
    e0, e3, e4, e5 = p[6], p[9], p[10], p[11]
    b0, b3, b4, b5 = p[12], p[15], p[16], p[17]
    f = np.float32
    a_tx_x = f(t0 * f(2.0) / f(w_out))
    b_tx_x = f(t4 - t0)
    a_uv_x = f(e0 * a_tx_x)
    b_uv_x = f(f(e0 * b_tx_x) + e4)
    ax = f(a_uv_x * f(w_in))
    bx = f(f(b_uv_x * f(w_in)) - f(0.5))
    a_tx_y = f(t3 * f(2.0) / f(h_out))
    b_tx_y = f(t5 - t3)
    a_uv_y = f(e3 * a_tx_y)
    b_uv_y = f(f(e3 * b_tx_y) + e5)
    ay = f(a_uv_y * f(h_in))
    by = f(f(b_uv_y * f(h_in)) - f(0.5))
    a_bd_x = f(b0 * f(2.0) / f(w_out))
    b_bd_x = f(b4 - b0)
    a_bd_y = f(b3 * f(2.0) / f(h_out))
    b_bd_y = f(b5 - b3)
    return np.array([ay, by, ax, bx, a_tx_y, b_tx_y, a_tx_x, b_tx_x,
                     a_bd_y, b_bd_y, a_bd_x, b_bd_x], np.float32)


def hat_matrix(n_out: int, n_in: int, a: float, b: float,
               transpose: bool = False) -> np.ndarray:
    """Two-tap bilinear sampling matrix with clamp-to-edge taps.

    Row r carries weight (1-f) at floor(x) and f at floor(x)+1 for
    x = clip(a*r + b, 0, n_in-1); when x clamps, the single surviving tap
    carries the full weight — exactly ``golden.bilinear_norm``'s
    xi0/xi1 = clip(floor(x)(+1)) semantics.
    """
    r = np.arange(n_out, dtype=np.float64)
    x = np.float32(a) * r.astype(np.float32) + np.float32(b)
    x = np.clip(x, 0.0, np.float32(n_in - 1))
    k0 = np.floor(x).astype(np.int64)
    f = (x - k0).astype(np.float32)
    k1 = np.minimum(k0 + 1, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), k0] += (1.0 - f)
    m[np.arange(n_out), k1] += f
    return m.T if transpose else m


class ScalePlan(NamedTuple):
    """Host-precomputed sampling matrices for one y420p->y420p geometry."""
    vy: np.ndarray   # [oh, ih]
    hy: np.ndarray   # [iw, ow]
    vc: np.ndarray   # [oh/2, ih/2]
    hc: np.ndarray   # [iw/2, ow/2]
    out_size: Tuple[int, int]


def plan_scale(uniform, out_size: Tuple[int, int],
               in_shape: Tuple[int, int]) -> Optional[ScalePlan]:
    """Build a ScalePlan from composite uniforms, or None if the mapping
    is not a pure full-coverage scale (caller falls back to the general
    composite path).

    Eligible: axis-aligned, opacity == 1, the element's border and
    texture cover the whole output canvas (identity_uniforms-style
    mappings: the ladder rungs and wall cells).
    """
    w, h = out_size
    h_in, w_in = in_shape
    p = np.asarray(golden._packed(uniform), np.float64)
    if not golden.is_axis_aligned(p):
        return None
    if abs(float(p[22]) - 1.0) > 1e-9:        # opacity
        return None
    pl_ = _plane_params_np(np.asarray(p, np.float32), h, w, h_in, w_in)
    ay, by, ax, bx = (float(pl_[0]), float(pl_[1]),
                      float(pl_[2]), float(pl_[3]))
    if ay <= 0 or ax <= 0:
        return None
    # border + texture must cover every output pixel (corners suffice —
    # the maps are affine)
    for (aa, bb, n) in ((pl_[4], pl_[5], h), (pl_[6], pl_[7], w),
                        (pl_[8], pl_[9], h), (pl_[10], pl_[11], w)):
        lo = float(aa) * 0.0 + float(bb)
        hi = float(aa) * (n - 1) + float(bb)
        if not (min(lo, hi) >= -1e-6 and max(lo, hi) <= 1.0 + 1e-6):
            return None
    if h % 2 or w % 2 or h_in % 2 or w_in % 2:
        return None
    pc = _plane_params_np(np.asarray(p, np.float32), h // 2, w // 2,
                          h_in // 2, w_in // 2)
    ayc, byc, axc, bxc = (float(pc[0]), float(pc[1]),
                          float(pc[2]), float(pc[3]))
    return ScalePlan(
        vy=hat_matrix(h, h_in, ay, by),
        hy=hat_matrix(w, w_in, ax, bx, transpose=True),
        vc=hat_matrix(h // 2, h_in // 2, ayc, byc),
        hc=hat_matrix(w // 2, w_in // 2, axc, bxc, transpose=True),
        out_size=out_size,
    )


_HIGH = jax.lax.Precision.HIGH


def _scale_plane(x, v, hmat):
    t = jnp.dot(v, x.astype(jnp.float32), precision=_HIGH)
    s = jnp.dot(t, hmat, precision=_HIGH)
    return jnp.clip(jnp.rint(s), 0.0, 255.0).astype(jnp.uint8)


def scale_y420p(planes: Sequence, plan: ScalePlan):
    """Scale one y420p frame (y, cb, cr) -> plan.out_size.  Jittable; pass
    device arrays for the planes and keep the plan static (hat matrices
    become jit constants)."""
    y, cb, cr = planes
    return (_scale_plane(y, jnp.asarray(plan.vy), jnp.asarray(plan.hy)),
            _scale_plane(cb, jnp.asarray(plan.vc), jnp.asarray(plan.hc)),
            _scale_plane(cr, jnp.asarray(plan.vc), jnp.asarray(plan.hc)))


def scale_y420p_batch(ys, us, vs, plan: ScalePlan):
    """[N, H, W] (+half-res chroma) -> batched scaled planes.  The batch
    axis is the matmuls' batch dimension; shard it over a mesh for the
    mixing wall (parallel/wall.py)."""
    f = jax.vmap(lambda y, u, v: scale_y420p((y, u, v), plan))
    return f(ys, us, vs)
