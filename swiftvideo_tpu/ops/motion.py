"""Motion estimation: full-search SAD with MV-cost scoring.

Reference semantics: the Metal ``me_fullsearch`` kernel
(kernels.metal:130-267): for each BxB block of the current frame, scan every
candidate position in a clamped search window of the reference frame
(x-major, then y), score = ``deltaCost2(mv) + SAD * 256``, keep the first
strict minimum, clamp the winning MV to +-searchWindow/2, and emit an RGBA
image of normalized vectors ``(mv.x*0.5+0.5, 0.5, mv.y*0.5+0.5, 1.0)`` at
block resolution.

Scoring contract: SAD is the exact integer sum of |cur - ref| over the u8
block, scaled by 256/255 into the reference's UNORM*256 range (the Metal
kernel sums UNORM floats; exact integers make ties deterministic, which a
float-summation oracle cannot).  Ties break to the earliest candidate in
(tx, ty) scan order, matching the reference's x-major strict-minimum loop.

Implementations:

* ``me_fullsearch_golden`` — scalar-loop numpy oracle.
* ``me_fullsearch_device`` — the device entry: XLA ``lax.scan`` over the
  global displacement set for exact SAD (any geometry), or the SSD
  matmul variant (``metric="ssd"``, section below).
* ``me_fullsearch_pyramid`` — experimental two-stage mode.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np

_LAMBDA = 4.0
_QPEX = 4.0
_SCALE = np.float32(256.0 / 255.0)   # integer SAD -> UNORM*256 score units


def delta_cost2(mvx, mvy, xp=np):
    """kernels.metal:138-145"""
    def comp(v):
        log2v = xp.log2(xp.abs(v) + 1.0)
        rounding = (v != 0).astype(xp.float32)
        return _LAMBDA * (log2v * 2.0 + 0.718 + rounding) + 0.5
    return _QPEX * (comp(mvx) + comp(mvy))


def _search_bounds(o: int, block: int, search: int, size: int) -> Tuple[int, int]:
    """Candidate t range [lo, hi) for a block at origin ``o``
    (kernels.metal searchExtent + scan conditions)."""
    left = min(max(o + block // 2 - search // 2, 0), size)
    right = min(max(left + search, 0), size)
    return left, right - block  # t in [left, right - block)


def _cost_f32(mvx: float, mvy: float) -> np.float32:
    return np.float32(delta_cost2(np.float64(mvx), np.float64(mvy)))


def me_fullsearch_golden(cur: np.ndarray, ref: np.ndarray, block: int = 16,
                         search: int = 64) -> np.ndarray:
    """Scalar-loop oracle.  cur/ref: [H, W] u8 luma.  Returns [Hb, Wb, 4] u8."""
    h, w = cur.shape
    hb, wb = h // block, w // block
    curi = cur.astype(np.int32)
    refi = ref.astype(np.int32)
    out = np.zeros((hb, wb, 4), np.uint8)
    max_mv = search // 2
    for by in range(hb):
        for bx in range(wb):
            oy, ox = by * block, bx * block
            xlo, xhi = _search_bounds(ox, block, search, w)
            ylo, yhi = _search_bounds(oy, block, search, h)
            best = (math.inf, 0.0, 0.0)
            cb = curi[oy:oy + block, ox:ox + block]
            for tx in range(xlo, xhi):
                for ty in range(ylo, yhi):
                    sad = int(np.abs(cb - refi[ty:ty + block,
                                               tx:tx + block]).sum())
                    mvx, mvy = float(ox - tx), float(oy - ty)
                    score = np.float32(_cost_f32(mvx, mvy)
                                       + np.float32(np.float32(sad) * _SCALE))
                    if score < best[0]:
                        best = (score, mvx, mvy)
            mvx = min(max(best[1], -max_mv), max_mv) / max_mv * 0.5 + 0.5
            mvy = min(max(best[2], -max_mv), max_mv) / max_mv * 0.5 + 0.5
            out[by, bx] = np.clip(np.rint(np.array(
                [mvx, 0.5, mvy, 1.0]) * 255.0), 0, 255).astype(np.uint8)
    return out


def _mv_rgba(mvx, mvy, search: int, xp):
    """Normalized-vector RGBA emit shared by the device paths."""
    import jax.numpy as jnp
    max_mv = search // 2
    nx = xp.clip(mvx, -max_mv, max_mv) / max_mv * 0.5 + 0.5
    ny = xp.clip(mvy, -max_mv, max_mv) / max_mv * 0.5 + 0.5
    rgba = xp.stack([nx, xp.full_like(nx, 0.5), ny,
                     xp.ones_like(nx)], axis=-1)
    return xp.clip(jnp.rint(rgba * 255.0), 0, 255).astype(jnp.uint8)


@lru_cache(maxsize=16)
def _me_program(h: int, w: int, block: int, search: int,
                raw: bool = False):
    """``raw``: return (mvx, mvy) f32 fields instead of the RGBA
    normalization (consumed by the pyramid refine stage)."""
    import jax
    import jax.numpy as jnp

    hb, wb = h // block, w // block
    # global displacement range d = t - o (see _search_bounds):
    # lo = block/2 - search/2 (interior), hi = search - block - 1 (edge)
    d_lo = block // 2 - search // 2
    d_hi = search - block - 1
    drange = np.arange(d_lo, d_hi + 1, dtype=np.int32)
    # candidate list in reference scan order: x outer, y inner
    # reshape keeps the (0, 2) shape when the range is empty
    # (search <= block): the scan runs zero steps and every block keeps
    # the init zero MV, matching the oracle's empty candidate window
    cand = np.array([(dx, dy) for dx in drange for dy in drange],
                    np.int32).reshape(-1, 2)

    # per-block clamped candidate bounds
    ox = np.arange(wb, dtype=np.int32) * block
    oy = np.arange(hb, dtype=np.int32) * block

    def bounds(o, size):
        left = np.clip(o + block // 2 - search // 2, 0, size)
        right = np.clip(left + search, 0, size)
        return left, right - block

    xlo, xhi = bounds(ox, w)   # [wb]
    ylo, yhi = bounds(oy, h)   # [hb]

    def run(cur_u8, ref_u8):
        # blocks tile the top-left hb*block x wb*block region (1080 rows
        # hold 67 whole 16-row strips); candidates still read the full frame
        cur = cur_u8[:hb * block, :wb * block].astype(jnp.int32)
        ref = ref_u8.astype(jnp.int32)
        pad = search
        refp = jnp.pad(ref, ((pad, pad), (pad, pad)))

        def step(carry, d):
            best_score, best_dx, best_dy = carry
            dx, dy = d[0], d[1]
            shifted = jax.lax.dynamic_slice(refp, (pad + dy, pad + dx),
                                            (hb * block, wb * block))
            diff = jnp.abs(cur - shifted)
            sad = diff.reshape(hb, block, wb, block).sum(axis=(1, 3))
            # candidate t = o + d must lie in [lo, hi) per block axis
            vx = (ox + dx >= xlo) & (ox + dx < xhi)          # [wb]
            vy = (oy + dy >= ylo) & (oy + dy < yhi)          # [hb]
            valid = vy[:, None] & vx[None, :]
            mvx, mvy = (-dx).astype(jnp.float32), (-dy).astype(jnp.float32)
            score = (delta_cost2(mvx, mvy, jnp).astype(jnp.float32)
                     + sad.astype(jnp.float32) * _SCALE)
            score = jnp.where(valid, score, jnp.inf)
            better = score < best_score
            return (jnp.where(better, score, best_score),
                    jnp.where(better, mvx, best_dx),
                    jnp.where(better, mvy, best_dy)), None

        init = (jnp.full((hb, wb), jnp.inf, jnp.float32),
                jnp.zeros((hb, wb), jnp.float32),
                jnp.zeros((hb, wb), jnp.float32))
        (score, mvx, mvy), _ = jax.lax.scan(step, init, jnp.asarray(cand))
        if raw:
            return mvx, mvy
        return _mv_rgba(mvx, mvy, search, jnp)

    return jax.jit(run)


def me_fullsearch_device(cur, ref, block: int = 16, search: int = 64,
                         metric: str = "sad"):
    """Device full-search: cur/ref [H, W] u8 -> [H//B, W//B, 4] u8 MVs.

    ``metric="sad"`` is the reference-parity path (kernels.metal:206-267
    semantics): the XLA scan.  ``metric="ssd"`` is the documented matmul
    variant (`me_fullsearch_mxu`): same search geometry and MV-cost, SSD
    distortion instead of SAD, with the cross term as a convolution.
    """
    import jax.numpy as jnp
    cur = jnp.asarray(cur)
    h, w = cur.shape
    if metric == "ssd":
        # the ungrouped conv: on the H100 it both compiles and runs faster
        # than the grouped (feature_group_count) formulation (PERF.md)
        return _me_mxu_program(h, w, block, search)(cur, jnp.asarray(ref))
    return _me_program(h, w, block, search)(cur, jnp.asarray(ref))


# --- SSD matmul variant ----------------------------------------------------
#
# Exact SAD is elementwise work: 4.7e9 abs-diffs per 1080p/16/64 frame.
# The SSD variant changes the distortion metric to SSD, which decomposes
# as ||c||^2 - 2*c.r + ||r||^2:
#
#   * the cross term c.r over a 16x16 block is a 256-deep contraction —
#     expressed as `lax.conv` of each strip's reference window with the
#     strip's current blocks as filters, it runs on the matrix units
#     (u8 pixels are exact in bf16; each product is <= 65025 and a
#     block's 256 of them sum below 2^24, so f32 accumulation is exact
#     in any order);
#   * ||r||^2 patch sums come from two separable integer reduce_windows;
#   * ||c||^2 is constant per block, so it cannot change the argmin and
#     is dropped from the computed score.
#
# Variant score (documented deviation from the reference's SAD*256):
#   score = Cy(mvy) + Cx(mvx) + SSD * 2^-4
# where Cx/Cy are the per-axis halves of deltaCost2 (which is separable:
# qpex*(comp(x) + comp(y))), computed as
#   f32(f32(SSD_partial * 2^-4 + Cy) + Cx),  SSD_partial = SSD - ||c||^2
# (same argmin as full SSD).  Exactness contract: the 2^-4 scale is a
# power of two so the product is exact in f32 (FMA == two-step), each
# cost add rounds once in a fixed order, and the numpy oracle
# (`me_ssd_golden`) mirrors that order bit-for-bit — candidate-exact.
# The SEPARABLE form lets the device reduce over dy on the full
# correlation volume (fusable with the conv consumer) and defer the
# per-block gather to the tiny [wb, n_d] dy-reduced plane.  Ties break
# to the earliest candidate in (tx, ty) x-major scan order: the outer
# min is over tx (strictly increasing in the inner), the inner over ty.

_SCALE2 = np.float32(2.0 ** -4)   # integer (SSD - ||c||^2) -> score units


def _axis_cost(v, xp=np):
    """Per-axis half of deltaCost2 (kernels.metal:138-145), f64 in."""
    log2v = xp.log2(xp.abs(v) + 1.0)
    rounding = (v != 0).astype(np.float64)
    return _QPEX * (_LAMBDA * (log2v * 2.0 + 0.718 + rounding) + 0.5)


def me_ssd_golden(cur: np.ndarray, ref: np.ndarray, block: int = 16,
                  search: int = 64) -> np.ndarray:
    """Scalar-loop oracle for the SSD variant; mirrors the device score
    ops bit-exactly (see the variant-score note above)."""
    h, w = cur.shape
    hb, wb = h // block, w // block
    curi = cur.astype(np.int64)
    refi = ref.astype(np.int64)
    out = np.zeros((hb, wb, 4), np.uint8)
    max_mv = search // 2
    for by in range(hb):
        for bx in range(wb):
            oy, ox = by * block, bx * block
            xlo, xhi = _search_bounds(ox, block, search, w)
            ylo, yhi = _search_bounds(oy, block, search, h)
            best = (math.inf, 0.0, 0.0)
            cb = curi[oy:oy + block, ox:ox + block]
            for tx in range(xlo, xhi):
                cx = np.float32(_axis_cost(np.float64(ox - tx)))
                for ty in range(ylo, yhi):
                    rb = refi[ty:ty + block, tx:tx + block]
                    partial = int((rb * rb).sum()) - 2 * int((cb * rb).sum())
                    cy = np.float32(_axis_cost(np.float64(oy - ty)))
                    inner = np.float32(np.float32(partial) * _SCALE2 + cy)
                    score = np.float32(inner + cx)
                    if score < best[0]:
                        best = (score, float(ox - tx), float(oy - ty))
            mvx = min(max(best[1], -max_mv), max_mv) / max_mv * 0.5 + 0.5
            mvy = min(max(best[2], -max_mv), max_mv) / max_mv * 0.5 + 0.5
            out[by, bx] = np.clip(np.rint(np.array(
                [mvx, 0.5, mvy, 1.0]) * 255.0), 0, 255).astype(np.uint8)
    return out


@lru_cache(maxsize=16)
def _me_mxu_program(h: int, w: int, block: int, search: int,
                    grouped: bool = False, unroll: int = 0,
                    raw: bool = False, stride: int = 1):
    """``grouped``: block-column groups + ``feature_group_count`` conv —
    each group of ``gs`` blocks convolves only its own x-segment
    (16*(gs-1) + n_d positions instead of all of W), cutting the dense
    formulation's ~40x x-waste to ~1x.  Same scores bit-for-bit; whether
    it is faster depends on XLA's grouped-conv lowering (measure).
    ``unroll``: strips per fused scan step; 0 = FULL unroll (capped at
    80) — per-op fixed costs over ~68 small-tensor scan iterations
    dominate this program.
    ``stride``: candidate-grid subsampling (grouped path only) — scores
    only every ``stride``-th dx (via the conv's ``window_strides``, so
    the conv work drops by 1/stride with unchanged shapes) and every
    ``stride``-th dy (fewer batch rows).  The winner is the best
    candidate ON THE SUBSAMPLED GRID, which is within stride-1 per axis
    of the exhaustive optimum's position — the coarse stage of the
    two-stage production mode (`me_fullsearch_pyramid`)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    # exactness contract: 2*block^2 products of u8 pairs must accumulate
    # exactly in f32 (and partial = r2 - 2*cross in i32)
    if block * block * 255 * 255 >= 2 ** 24:
        raise ValueError("ssd variant requires block <= 16 for exact f32 "
                         "accumulation")
    if search <= block:
        # degenerate geometry: the candidate window [lo, hi - block) is
        # empty for every block (see _search_bounds), so the oracle emits
        # the zero MV everywhere.  The SAD scan program reduces over an
        # empty candidate list and produces exactly that; the SSD
        # formulation below would build zero-width conv segments instead.
        return _me_program(h, w, block, search, raw)
    strips, wb = h // block, w // block
    if not unroll:
        unroll = min(strips, 80)
    d_lo = block // 2 - search // 2
    d_hi = search - block - 1
    n_d = d_hi - d_lo + 1
    # candidate dx grid (subsampled by ``stride``; stride 1 == exhaustive)
    dxs = np.arange(d_lo, d_hi + 1, stride, dtype=np.int32)
    n_c = len(dxs)
    n_j = search - block                       # per-strip ty candidates

    # per-strip ty windows (see _search_bounds)
    oy = np.arange(strips, dtype=np.int32) * block
    ylo = np.clip(oy + d_lo, 0, h)
    yhi = np.minimum(ylo + search, h) - block
    nvy = np.maximum(yhi - ylo, 0)
    jgbase = (ylo - oy) - d_lo                 # dy-cost index base

    # per-block-column dx validity + gather columns
    ox = np.arange(wb, dtype=np.int32) * block
    xlo = np.clip(ox + d_lo, 0, w)
    xhi = np.minimum(xlo + search, w) - block
    txg = ox[:, None] + dxs[None, :]           # [wb, n_c] candidate tx
    xmask = (txg >= xlo[:, None]) & (txg < xhi[:, None])
    txg = np.clip(txg, 0, w - block)

    gs = 0
    if grouped:
        gs = next((g for g in (8, 6, 5, 4, 3, 2) if wb % g == 0), 0)
        if not gs:
            grouped = False
    if stride != 1 and not grouped:
        raise ValueError("candidate stride requires the grouped conv path")
    if grouped:
        n_groups = wb // gs
        seg_p = block * (gs - 1) + n_d         # positions per group
        seg_w = seg_p + block - 1              # conv input cols per group
        seg_x0 = (block * gs * np.arange(n_groups, dtype=np.int32)
                  + d_lo)                      # absolute first tx per group
        # gather index into the dy-reduced [ceil(seg_p/stride), wb] plane:
        # p = (16*(f % gs) + dx - d_lo) / stride — exact since block and
        # (dx - d_lo) are both multiples of stride for stride in {1, 2}
        if stride != 1 and block % stride:
            raise ValueError("stride must divide the block size")
        pg = ((block * (np.arange(wb, dtype=np.int32) % gs))[:, None]
              + (dxs - d_lo)[None, :]) // stride    # [wb, n_c]
        pad_l = -d_lo
        pad_r = max(int(seg_x0[-1]) + seg_w - w, 0) + 8

    # separable per-axis f32 MV-cost tables (see variant-score note);
    # cx is per candidate dx (subsampled grid), cy stays indexed by the
    # FULL global dy index (j values remain actual offsets under stride)
    dvals_full = (d_lo + np.arange(n_d)).astype(np.float64)
    cx_tab = _axis_cost(-dxs.astype(np.float64)).astype(np.float32)
    cy_tab = _axis_cost(-dvals_full).astype(np.float32)  # [n_d] by dy index

    big_key = np.int32(2 ** 30)

    def run(cur_u8, ref_u8):
        cur_u8 = cur_u8[:strips * block]
        if grouped:
            refp = jnp.pad(ref_u8, ((0, search), (pad_l, pad_r)))
        else:
            refp = jnp.pad(ref_u8, ((0, search), (0, 0)))
        # ||r||^2 patch sums via separable integer window sums (exact:
        # block^2 * 255^2 < 2^24 for block <= 16; i32 regardless)
        r2c = lax.reduce_window(
            (refp.astype(jnp.int32)) ** 2, 0, lax.add,
            (block, 1), (1, 1), "valid")
        s2 = lax.reduce_window(r2c, 0, lax.add, (1, block), (1, 1), "valid")

        # filters: strip s blocks as [block(jj), block(i), wb] bf16 for the
        # channels-folded 1D conv below
        filt = (cur_u8.reshape(strips, block, wb, block)
                .transpose(0, 3, 1, 2)
                .astype(jnp.bfloat16))
        wins = jnp.take(refp, ylo[:, None] + np.arange(search)[None, :],
                        axis=0)                # [strips, search, wpad] u8
        iwb = jnp.arange(wb)[:, None]
        j_iota = jnp.arange(0, n_j, stride, dtype=jnp.int32)

        def body(_, xs):
            win, f, nvy_s, jgb_s, ylo_s, oy_s = xs
            # channels-folded correlation: folding the 16 vertical taps
            # into input CHANNELS makes a direct C_in=1 2D conv a
            # [kw=16, C_in=16, C_out=wb] 1D conv with a 256-deep
            # contraction and j as the batch axis
            v = jnp.stack([win[i:i + n_j:stride] for i in range(block)],
                          axis=-1).astype(jnp.bfloat16)  # [n_js, wpad, 16]
            rows = jnp.clip(ylo_s + j_iota, 0, h - block)
            if grouped:
                # per-group x-segments as channel blocks: group g's gs
                # blocks see only their own seg_w columns via
                # feature_group_count (see docstring); candidate stride
                # rides the conv's window_strides (output positions are
                # every stride-th p, matching the pg gather index)
                vseg = jnp.concatenate(
                    [v[:, int(s0) + pad_l:int(s0) + pad_l + seg_w, :]
                     for s0 in seg_x0], axis=-1)  # [n_js, seg_w, G*16]
                cross = lax.conv_general_dilated(
                    vseg, f, window_strides=(stride,), padding="VALID",
                    dimension_numbers=("NWC", "WIO", "NWC"),
                    feature_group_count=n_groups,
                    preferred_element_type=jnp.float32,
                )                              # [n_js, ceil(seg_p/st), wb]
                r2g = jnp.stack(
                    [s2[rows][:, int(s0) + pad_l:
                              int(s0) + pad_l + seg_p:stride]
                     for s0 in seg_x0], axis=2)
                r2row = jnp.repeat(r2g, gs, axis=2)
                partial = r2row - 2 * cross.astype(jnp.int32)
                gidx = pg_j
            else:
                cross = lax.conv_general_dilated(
                    v, f, window_strides=(1,), padding="VALID",
                    dimension_numbers=("NWC", "WIO", "NWC"),
                    preferred_element_type=jnp.float32,
                )                              # [n_j, wx, wb]
                r2row = s2[rows][:, :, None]   # [n_j, wx, 1]
                partial = r2row - 2 * cross.astype(jnp.int32)
                gidx = txg_j
            # inner stage: reduce over dy on the FULL volume in ONE pass —
            # a variadic lexicographic reduce carries (score, j) together,
            # so the 44 MB/strip volume is read once, not twice
            cy_s = cy_tab[jnp.clip(jgb_s + j_iota, 0, n_d - 1)]
            inner = partial.astype(jnp.float32) * _SCALE2 \
                + cy_s[:, None, None]
            inner = jnp.where((j_iota < nvy_s)[:, None, None], inner,
                              jnp.inf)
            jvol = jnp.broadcast_to(j_iota[:, None, None], inner.shape)

            def lex_min(a, b):
                sa, ka = a
                sb, kb = b
                tb = (sb < sa) | ((sb == sa) & (kb < ka))
                return jnp.where(tb, sb, sa), jnp.where(tb, kb, ka)

            m1, k1 = lax.reduce((inner, jvol),
                                (jnp.float32(jnp.inf), big_key),
                                lex_min, (0,))   # [wx, wb] each
            # outer stage: gather the dy-reduced plane per block (tiny)
            tg = m1[gidx, iwb]                 # [wb, n_c]
            jg = k1[gidx, iwb]
            score = tg + cx_tab[None, :]
            score = jnp.where(xmask, score, jnp.inf)
            m = jnp.min(score, axis=1)         # [wb]
            km = jnp.min(jnp.where(score == m[:, None],
                                   jnp.arange(n_c, dtype=jnp.int32)[None],
                                   big_key), axis=1)
            j_best = jg[jnp.arange(wb), km]
            # empty candidate window (all-inf scores: frame edge leaves no
            # valid tx/ty) -> the oracle's zero MV, not masked garbage
            valid = jnp.isfinite(m)
            mvx = jnp.where(valid,
                            (-jnp.asarray(dxs))[km].astype(jnp.float32), 0.0)
            mvy = jnp.where(valid,
                            (oy_s - (ylo_s + j_best)).astype(jnp.float32),
                            0.0)
            return None, (mvx, mvy)

        _, (mvx, mvy) = lax.scan(
            body, None,
            (wins, filt, jnp.asarray(nvy), jnp.asarray(jgbase),
             jnp.asarray(ylo), jnp.asarray(oy)),
            unroll=unroll)
        if raw:
            return mvx, mvy
        return _mv_rgba(mvx, mvy, search, jnp)

    cx_tab = jnp.asarray(cx_tab)
    cy_tab = jnp.asarray(cy_tab)
    txg_j = jnp.asarray(txg)
    pg_j = jnp.asarray(pg) if grouped else None
    xmask = jnp.asarray(xmask)
    return jax.jit(run)


@lru_cache(maxsize=8)
def _me_mxu_batched_program(h: int, w: int, block: int, search: int):
    """Strip-BATCHED grouped formulation: the whole frame as ONE conv.

    The scan variants above pay a per-strip fixed cost (the FLOPs are
    trivial, the op count is not).  Here the (strip, x-segment) pair
    folds into ``feature_group_count`` — a depthwise-style grouped 1D
    conv with S*G groups, C_in 16 and C_out ``gs`` per group — so every
    strip's cross-correlation runs in one conv and the dy lexicographic
    reduce runs once over the stacked volume, at the price of ~600 MB of
    intermediates at 1080p.  Bit-identical scores to the scanned grouped
    variant (same per-element arithmetic; lex-min is order-independent).
    Falls back to the scanned program when no group size divides the
    block columns or the geometry is degenerate."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    if block * block * 255 * 255 >= 2 ** 24:
        raise ValueError("ssd variant requires block <= 16 for exact f32 "
                         "accumulation")
    if search <= block:
        return _me_program(h, w, block, search)
    strips, wb = h // block, w // block
    gs = next((g for g in (8, 6, 5, 4, 3, 2) if wb % g == 0), 0)
    if not gs:
        return _me_mxu_program(h, w, block, search, False)
    d_lo = block // 2 - search // 2
    d_hi = search - block - 1
    n_d = d_hi - d_lo + 1
    dxs = np.arange(d_lo, d_hi + 1, dtype=np.int32)
    n_j = search - block

    oy = np.arange(strips, dtype=np.int32) * block
    ylo = np.clip(oy + d_lo, 0, h)
    yhi = np.minimum(ylo + search, h) - block
    nvy = np.maximum(yhi - ylo, 0)
    jgbase = (ylo - oy) - d_lo

    ox = np.arange(wb, dtype=np.int32) * block
    xlo = np.clip(ox + d_lo, 0, w)
    xhi = np.minimum(xlo + search, w) - block
    txg = ox[:, None] + dxs[None, :]
    xmask = (txg >= xlo[:, None]) & (txg < xhi[:, None])

    n_groups = wb // gs
    seg_p = block * (gs - 1) + n_d
    seg_w = seg_p + block - 1
    seg_x0 = block * gs * np.arange(n_groups, dtype=np.int32) + d_lo
    pg = (block * (np.arange(wb, dtype=np.int32) % gs))[:, None] \
        + (dxs - d_lo)[None, :]                # [wb, n_d] -> seg_p index
    pad_l = -d_lo
    pad_r = max(int(seg_x0[-1]) + seg_w - w, 0) + 8

    dvals = (d_lo + np.arange(n_d)).astype(np.float64)
    cx_tab = jnp.asarray(_axis_cost(-dvals).astype(np.float32))
    cy_tab_np = _axis_cost(-dvals).astype(np.float32)
    # per-(strip, j) dy-cost / validity, pre-spread over the channel axis
    jj = np.arange(n_j, dtype=np.int32)
    cy_sj = cy_tab_np[np.clip(jgbase[:, None] + jj[None, :], 0, n_d - 1)]
    cyv = jnp.asarray(np.repeat(cy_sj.T, wb, axis=1))      # [n_j, S*wb]
    validv = jnp.asarray(np.repeat((jj[None, :] < nvy[:, None]).T,
                                   wb, axis=1))            # [n_j, S*wb]
    big_key = np.int32(2 ** 30)

    def run(cur_u8, ref_u8):
        cur_u8 = cur_u8[:strips * block]
        refp = jnp.pad(ref_u8, ((0, search), (pad_l, pad_r)))
        r2c = lax.reduce_window(
            (refp.astype(jnp.int32)) ** 2, 0, lax.add,
            (block, 1), (1, 1), "valid")
        s2 = lax.reduce_window(r2c, 0, lax.add, (1, block), (1, 1), "valid")

        # rhs: strip-major per-block filters [kw, C_in, S*wb]
        filt = (cur_u8.reshape(strips, block, wb, block)
                .transpose(0, 3, 1, 2)         # [S, kw, 16, wb]
                .astype(jnp.bfloat16)
                .transpose(1, 2, 0, 3)
                .reshape(block, block, strips * wb))

        wins = jnp.take(refp, ylo[:, None] + np.arange(search)[None, :],
                        axis=0)                # [S, search, wpad] u8
        vb = jnp.stack([wins[:, i:i + n_j, :] for i in range(block)],
                       axis=-1).astype(jnp.bfloat16)   # [S, n_j, wpad, 16]
        vseg = jnp.concatenate(
            [vb[:, :, int(s0) + pad_l:int(s0) + pad_l + seg_w, :]
             for s0 in seg_x0], axis=-1)       # [S, n_j, seg_w, G*16]
        lhs = (vseg.transpose(1, 2, 0, 3)
               .reshape(n_j, seg_w, strips * n_groups * block))

        cross = lax.conv_general_dilated(
            lhs, filt, window_strides=(1,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"),
            feature_group_count=strips * n_groups,
            preferred_element_type=jnp.float32,
        )                                      # [n_j, seg_p, S*wb]

        rows = jnp.clip(ylo[:, None] + jj[None, :], 0, h - block)
        r2rows = s2[rows]                      # [S, n_j, wpad']
        r2g = jnp.stack(
            [r2rows[:, :, int(s0) + pad_l:int(s0) + pad_l + seg_p]
             for s0 in seg_x0], axis=3)        # [S, n_j, seg_p, G]
        r2row = (jnp.repeat(r2g, gs, axis=3)   # [S, n_j, seg_p, wb]
                 .transpose(1, 2, 0, 3)
                 .reshape(n_j, seg_p, strips * wb))
        partial = r2row - 2 * cross.astype(jnp.int32)

        inner = partial.astype(jnp.float32) * _SCALE2 + cyv[:, None, :]
        inner = jnp.where(validv[:, None, :], inner, jnp.inf)
        jvol = jnp.broadcast_to(jj[:, None, None], inner.shape)

        def lex_min(a, b):
            sa, ka = a
            sb, kb = b
            tb = (sb < sa) | ((sb == sa) & (kb < ka))
            return jnp.where(tb, sb, sa), jnp.where(tb, kb, ka)

        m1, k1 = lax.reduce((inner, jvol),
                            (jnp.float32(jnp.inf), big_key),
                            lex_min, (0,))     # [seg_p, S*wb]
        m1r = m1.reshape(seg_p, strips, wb).transpose(1, 2, 0)
        k1r = k1.reshape(seg_p, strips, wb).transpose(1, 2, 0)
        pgb = jnp.broadcast_to(jnp.asarray(pg)[None], (strips, wb, n_d))
        tg = jnp.take_along_axis(m1r, pgb, axis=2)   # [S, wb, n_d]
        jg = jnp.take_along_axis(k1r, pgb, axis=2)
        score = tg + cx_tab[None, None, :]
        score = jnp.where(jnp.asarray(xmask)[None], score, jnp.inf)
        m = jnp.min(score, axis=2)             # [S, wb]
        km = jnp.min(jnp.where(score == m[..., None],
                               jnp.arange(n_d, dtype=jnp.int32)[None, None],
                               big_key), axis=2)
        j_best = jnp.take_along_axis(jg, km[..., None], axis=2)[..., 0]
        # empty candidate window -> zero MV (see scan variant)
        valid = jnp.isfinite(m)
        mvx = jnp.where(valid, (-jnp.asarray(dxs))[km].astype(jnp.float32),
                        0.0)
        mvy = jnp.where(
            valid,
            (oy[:, None] - (ylo[:, None] + j_best)).astype(jnp.float32), 0.0)
        return _mv_rgba(mvx, mvy, search, jnp)

    return jax.jit(run)


def me_fullsearch_mxu(cur, ref, block: int = 16, search: int = 64,
                      grouped: bool = False, batched: bool = False):
    """SSD-variant full search (see module notes above)."""
    import jax.numpy as jnp
    cur = jnp.asarray(cur)
    h, w = cur.shape
    if batched:
        return _me_mxu_batched_program(h, w, block,
                                       search)(cur, jnp.asarray(ref))
    return _me_mxu_program(h, w, block, search,
                           grouped)(cur, jnp.asarray(ref))


# --- hierarchical (two-stage) mode -------------------------------------------
#
# Both stages avoid the patterns that make a coarse-to-fine search slow:
# no half-resolution decimation (u8 stride-2 slices), no per-block 4-D
# advanced-indexing gather.
#
#   * coarse = the SAME grouped-conv exhaustive program at FULL
#     resolution with a stride-2 CANDIDATE grid (conv window_strides +
#     subsampled dy rows): identical conv shapes, 1/4 the work, and the
#     winner is within 1 per axis of some grid point around the true
#     optimum's basin;
#   * refine = a strip-scanned re-score of (2*refine+1)^2 candidates
#     around each block's coarse pick, with the patch gather expressed
#     as a ROW take (whole cache lines) followed by a one-hot COLUMN
#     matmul (u8 values are exact in bf16), and the SSD cross/self terms
#     as two small matmuls per strip (a static-index take builds the
#     shifted-window view; ||r||^2 contracts against a static 0/1 window
#     matrix).  No dynamic multi-axis gather anywhere.

@lru_cache(maxsize=8)
def _me_refine_program(h: int, w: int, block: int, search: int,
                       refine: int, metric: str, unroll: int = 8):
    """Re-score ``(2*refine+1)**2`` candidates around per-block centers.

    Takes the coarse (mvx, mvy) f32 fields and returns the RGBA MV map.
    Scoring is bit-identical to the oracles (`me_ssd_golden` /
    `me_fullsearch_golden`): same f32 cost tables built in f64, same
    operation order, ties break to the earliest candidate in (tx, ty)
    x-major order.  Candidates outside a block's clamped search window
    are masked; if every candidate is masked the zero MV is emitted.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    hb, wb = h // block, w // block
    win = block + 2 * refine
    n_off = 2 * refine + 1
    oy = np.arange(hb, dtype=np.int32) * block
    ox = np.arange(wb, dtype=np.int32) * block

    def vb(o, size):
        left = np.clip(o + block // 2 - search // 2, 0, size)
        right = np.clip(left + search, 0, size)
        return left, right - block

    xlo, xhi = vb(ox, w)                       # [wb]
    ylo, yhi = vb(oy, h)                       # [hb]

    # candidate offsets in the golden tie order: tx-major, then ty
    offs = np.array([(ddx, ddy) for ddx in range(n_off)
                     for ddy in range(n_off)], np.int32)
    n_s = len(offs)

    # f32 cost tables built in f64 on host (same values as the oracles)
    dmax = search
    dvals = np.arange(-dmax, dmax + 1, dtype=np.float64)
    if metric == "ssd":
        ax_tab = jnp.asarray(_axis_cost(dvals).astype(np.float32))
        # shifted-window index map: candidate s's block view of the
        # flattened [win, win] patch (static, so the take lowers without
        # a dynamic gather)
        ii, jj = np.mgrid[0:block, 0:block]
        idxmap = np.stack([((ddy + ii) * win + (ddx + jj)).ravel()
                           for ddx, ddy in offs])          # [n_s, B*B]
        idx_flat = jnp.asarray(idxmap.reshape(-1))
    else:
        cost2d = jnp.asarray(np.float32(
            delta_cost2(dvals[:, None], dvals[None, :])))

    ddx_a = jnp.asarray(offs[:, 0])
    ddy_a = jnp.asarray(offs[:, 1])
    s_iota = jnp.arange(n_s, dtype=jnp.int32)
    big_key = np.int32(2 ** 30)

    def run(cur_u8, ref_u8, mvx_c, mvy_c):
        # candidate window origin per block: center t = o - coarse_mv,
        # clamped so the win x win patch stays inside the frame (the
        # candidate set shifts with the clamp, mirroring v1's semantics)
        tcy = oy[:, None] - mvy_c.astype(jnp.int32)
        tcx = ox[None, :] - mvx_c.astype(jnp.int32)
        gy0 = jnp.clip(tcy - refine, 0, h - win)           # [hb, wb]
        gx0 = jnp.clip(tcx - refine, 0, w - win)
        cb = (cur_u8[:hb * block, :wb * block]
              .reshape(hb, block, wb, block).transpose(0, 2, 1, 3))

        iw = jnp.arange(win, dtype=jnp.int32)
        lane = jnp.arange(w, dtype=jnp.int32)

        def body(_, xs):
            gy0r, gx0r, cbr, oy_s, ylo_s, yhi_s = xs
            # patch gather: rows by take (contiguous W-wide lines), then
            # columns by one-hot matmul (exact: u8 in bf16,
            # one 1 per output lane, f32 accumulation)
            rows = jnp.take(ref_u8, gy0r[:, None] + iw[None, :], axis=0,
                            mode="clip")                   # [wb, win, W]
            ci = gx0r[:, None] + iw[None, :]               # [wb, win]
            onehot = (lane[None, :, None]
                      == ci[:, None, :]).astype(jnp.bfloat16)
            patch = lax.dot_general(
                rows.astype(jnp.bfloat16), onehot,
                (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)        # [wb, win, win]

            ty = gy0r[:, None] + ddy_a[None, :]            # [wb, n_s]
            tx = gx0r[:, None] + ddx_a[None, :]
            valid = ((ty >= ylo_s) & (ty < yhi_s)
                     & (tx >= xlo[:, None]) & (tx < xhi[:, None]))
            dyi = oy_s - ty
            dxi = ox[:, None] - tx
            if metric == "ssd":
                pf = patch.reshape(wb, win * win)
                # ||r||^2 per candidate: block box sums of patch^2 —
                # exact f32 adds (values <= 255^2, sums < 2^24); window
                # position (ddy, ddx) reorders to the tx-major s index
                r2w = lax.reduce_window(
                    patch * patch, jnp.float32(0), lax.add,
                    (1, block, block), (1, 1, 1),
                    "valid")                   # [wb, n_off(dy), n_off(dx)]
                r2 = r2w.transpose(0, 2, 1).reshape(wb, n_s)
                # cross term: shifted-window views via a static-index
                # take, then a batched matvec against the block
                pg = jnp.take(pf, idx_flat, axis=1).reshape(
                    wb, n_s, block * block)
                cross = lax.dot_general(
                    pg.astype(jnp.bfloat16),
                    cbr.reshape(wb, block * block).astype(jnp.bfloat16),
                    (((2,), (1,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32)    # [wb, n_s]
                partial = r2 - 2.0 * cross
                cy = ax_tab[jnp.clip(dyi + dmax, 0, 2 * dmax)]
                cx = ax_tab[jnp.clip(dxi + dmax, 0, 2 * dmax)]
                score = (partial * _SCALE2 + cy) + cx
            else:
                # SAD is not bilinear, so it cannot ride the matmul
                # trick; n_s static slices of the small per-strip patch
                # volume stay cheap at strip granularity
                rbs = jnp.stack(
                    [patch[:, ddy:ddy + block, ddx:ddx + block]
                     for ddx, ddy in offs], axis=1)        # [wb, n_s, B, B]
                sad = jnp.abs(cbr[:, None].astype(jnp.float32)
                              - rbs).sum((2, 3))
                cost = cost2d[jnp.clip(dxi + dmax, 0, 2 * dmax),
                              jnp.clip(dyi + dmax, 0, 2 * dmax)]
                score = cost + sad * _SCALE
            score = jnp.where(valid, score, jnp.inf)
            m = jnp.min(score, axis=1)                     # [wb]
            km = jnp.min(jnp.where(score == m[:, None], s_iota[None, :],
                                   big_key), axis=1)
            ok = jnp.isfinite(m)
            mvx = jnp.where(
                ok, jnp.take_along_axis(dxi, km[:, None], axis=1)[:, 0]
                .astype(jnp.float32), 0.0)
            mvy = jnp.where(
                ok, jnp.take_along_axis(dyi, km[:, None], axis=1)[:, 0]
                .astype(jnp.float32), 0.0)
            return None, (mvx, mvy)

        _, (mvx, mvy) = lax.scan(
            body, None,
            (gy0, gx0, cb, jnp.asarray(oy), jnp.asarray(ylo),
             jnp.asarray(yhi)),
            unroll=min(unroll, hb))
        return _mv_rgba(mvx, mvy, search, jnp)

    return jax.jit(run)


@lru_cache(maxsize=8)
def _me_pyramid_program(h: int, w: int, block: int, search: int,
                        refine: int, metric: str):
    import jax

    wb = w // block
    gs = next((g for g in (8, 6, 5, 4, 3, 2) if wb % g == 0), 0)
    # coarse: the grouped-conv SSD program at full resolution with a
    # stride-2 candidate grid (1/4 the exhaustive work, same conv shapes);
    # if no group size divides the block columns, fall back to the
    # exhaustive dense coarse (rare geometry; refine is then a no-op
    # quality-wise but keeps the output contract uniform)
    coarse = _me_mxu_program(h, w, block, search, grouped=bool(gs),
                             raw=True, stride=2 if gs else 1)
    refine_p = _me_refine_program(h, w, block, search, refine, metric)

    def run(cur_u8, ref_u8):
        mvx_c, mvy_c = coarse(cur_u8, ref_u8)              # [hb, wb] f32
        return refine_p(cur_u8, ref_u8, mvx_c, mvy_c)

    return jax.jit(run)


def me_fullsearch_pyramid(cur, ref, block: int = 16, search: int = 64,
                          refine: int = 2, metric: str = "ssd"):
    """Two-stage hierarchical motion estimation — EXPERIMENTAL, not the
    production mode (beyond the reference, whose Metal kernel is
    exhaustive-only; the production speed mode is the exhaustive
    ``me_fullsearch_device(metric="ssd")`` search).

    Stage 1 (coarse) runs the grouped-conv SSD search at FULL
    resolution over a stride-2 candidate grid — every grid point is
    within 1 per axis of any exhaustive candidate, at 1/4 the conv
    work.  Stage 2 re-scores ``coarse_pick +- refine`` per block with
    the requested ``metric``'s exact scoring (same cost tables, tie
    order, and f32 arithmetic as the oracles), gathering candidate
    patches via row takes + one-hot column matmuls so no dynamic
    multi-axis gather reaches the compiler (see the section comment
    above).

    Per-strip fixed costs dominate this program family, so cutting conv
    FLOPs 4x buys little on the coarse stage, and the refine stage costs
    about as much as another coarse pass.  Hence: experimental, kept for
    the structure (a cheaper coarse stage would slot in) and for metric=
    "sad" refinement of SSD-guided candidates, which the exhaustive
    matmul path cannot express.

    NOT exhaustive (documented deviation): content where the stride-2
    SSD landscape is misleading beyond the +-refine margin — strongly
    aliased 1-px textures, or very-low-gradient regions where the MV
    cost term flattens the landscape — may pick a worse candidate than
    ``me_fullsearch_device`` (about 1% of interior blocks at 1080p on
    smooth sinusoid content under an odd global shift; none when the
    shift lies on the stride grid).  When the true optimum's basin
    contains the best grid candidate, ``refine >= 1`` recovers the
    exhaustive answer exactly; the tests assert exact interior
    agreement for grid-aligned translations and for smooth content at
    small frame sizes.

    Falls back to the exhaustive device path for geometries the
    two-stage mode cannot express (odd sizes, tiny blocks, degenerate
    windows).
    """
    import jax.numpy as jnp
    cur = jnp.asarray(cur)
    h, w = cur.shape
    if (h % 2 or w % 2 or block % 2 or search % 2 or block < 8
            or search <= block
            or w % block or h < block + 2 * refine
            or w < block + 2 * refine):
        return me_fullsearch_device(cur, ref, block, search, metric=metric)
    return _me_pyramid_program(h, w, block, search, refine,
                               metric)(cur, jnp.asarray(ref))
