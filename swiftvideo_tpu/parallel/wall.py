"""Multi-stream mixing wall sharded over a device mesh.

The scale-out story (SURVEY.md §2.7, BASELINE config 5): N live streams
composited into a grid wall plus an N-way audio mix.  The reference scales
by task parallelism (one pipeline per asset on its own queue); here the
streams become a **batch axis sharded over the mesh** —

* video: each device converts+scales its local shard of streams to wall
  tiles (embarrassingly parallel).  When the stream-to-tile assignment
  gives every device whole wall rows, the canvas stays sharded over its
  height with ZERO video collectives; otherwise the composited tiles ride
  one ``all_gather`` across the mesh (SURVEY §5.7's cross-chip tile
  gather — tiles total one canvas worth of bytes, so the gather is a
  single small NVLink transfer between GPUs) and every device assembles
  the wall,
* audio: local saturating mixes fold per device, then one ``psum`` over the
  mesh combines partial sums.

Layouts are general since round 3 (VERDICT r2 #6): rectangular ``gw x gh``
grids (48 streams as 6x8), stream counts that don't divide the mesh
(padded with blank cells), and meshes that don't own whole rows (gather
path).  Built with ``shard_map`` over a 1-D ``jax.sharding.Mesh`` — the
host's GPUs reach each other all to all, so the mesh follows the
algorithm alone; works identically on the virtual CPU mesh used in tests.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..media.pixel import PixelFormat
from ..ops import golden
from ..ops.uniforms import identity_uniforms


def make_mesh(devices=None, axis: str = "s") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


class MixingWall:
    """Grid composite of ``n_streams`` onto a ``gw x gh`` wall.

    Streams arrive as batched dense y420p planes ``[N, H, W]`` (+ half-res
    chroma) and interleaved s16 audio ``[N, samples]``; the step returns the
    composited wall planes and mixed audio, all device-resident (canvas
    sharded over rows on aligned layouts, replicated otherwise).
    """

    def __init__(self, mesh: Mesh, *, n_streams: int,
                 stream_size: Tuple[int, int],
                 canvas_size: Tuple[int, int],
                 grid: Optional[Tuple[int, int]] = None,
                 audio_samples: int = 960, channels: int = 2,
                 axis: str = "s"):
        self.mesh = mesh
        self.axis = axis
        n_dev = mesh.devices.size
        if grid is None:
            gw = int(math.ceil(math.sqrt(n_streams)))
            gh = int(math.ceil(n_streams / gw))
        else:
            gw, gh = grid
        if gw * gh < n_streams:
            raise ValueError(f"grid {gw}x{gh} holds fewer cells than "
                             f"{n_streams} streams")
        self.grid_wh = (gw, gh)
        self.grid = gw                      # back-compat (square layouts)
        self.n_streams = n_streams
        # stream counts that don't divide the mesh run padded with blank
        # cells (zero-gain audio)
        self.n_pad = -(-n_streams // n_dev) * n_dev
        self.stream_size = stream_size
        cw, ch = canvas_size
        if cw % gw or ch % gh:
            raise ValueError("canvas must divide into the wall grid")
        if (cw // gw) % 2 or (ch // gh) % 2:
            raise ValueError("wall tiles must have even dims (4:2:0 chroma)")
        self.canvas_size = canvas_size
        self.tile = (cw // gw, ch // gh)  # (w, h)
        self.audio_samples = audio_samples
        self.channels = channels
        local = self.n_pad // n_dev
        # aligned layout: no padding and every device owns whole wall rows
        # -> zero video collectives, canvas stays row-sharded
        self.aligned = (self.n_pad == n_streams and local % gw == 0
                        and gh % n_dev == 0 and local // gw == gh // n_dev)
        self._step = self._build(n_dev)

    # --- device program ---------------------------------------------------
    def _build(self, n_dev: int):
        gw, gh = self.grid_wh
        tw, th = self.tile
        sw, sh = self.stream_size
        local = self.n_pad // n_dev
        n = self.n_streams

        # default-uniform fast path: every cell is a pure full-coverage
        # scale -> two banded MXU matmuls per plane (ops/matscale.py), no
        # gathers.  Custom per-cell uniforms fall back to the general
        # composite fold.
        from ..ops.matscale import plan_scale, scale_y420p_batch
        self._plan = plan_scale(identity_uniforms(self.stream_size,
                                                  self.tile),
                                self.tile, (sh, sw))

        def scale_one(y, u, v, uni):
            """One stream -> one wall tile, with the stream's own composite
            uniforms (aspect fit / offset / opacity / fill per cell)."""
            target = [jnp.zeros((th, tw), jnp.uint8),
                      jnp.full((th // 2, tw // 2), 128, jnp.uint8),
                      jnp.full((th // 2, tw // 2), 128, jnp.uint8)]
            out = golden.apply_composite(target, PixelFormat.y420p,
                                         [y, u, v], PixelFormat.y420p,
                                         uni, xp=jnp, separable=True)
            return out[0], out[1], out[2]

        def rows_assemble(t, rows, cols, hh, wpx):
            return (t.reshape(rows, cols, hh, wpx)
                    .transpose(0, 2, 1, 3).reshape(rows * hh, cols * wpx))

        def mix_audio(audio, gains):
            # audio: local gain+sum in f32, then one psum across the mesh
            contrib = jnp.sum(audio.astype(jnp.float32) * gains[:, None],
                              axis=0)
            total = jax.lax.psum(contrib, self.axis)
            return jnp.clip(jnp.trunc(total), -32768,
                            32767).astype(jnp.int16)

        def assemble_aligned(ty, tu, tv, audio, gains):
            rows_per_dev = local // gw
            wall_y = rows_assemble(ty, rows_per_dev, gw, th, tw)
            wall_u = rows_assemble(tu, rows_per_dev, gw, th // 2, tw // 2)
            wall_v = rows_assemble(tv, rows_per_dev, gw, th // 2, tw // 2)
            return wall_y, wall_u, wall_v, mix_audio(audio, gains)

        def blank_fix(tiles, fill):
            """Mask padded / excess cells to a blank tile and extend to the
            full cell count."""
            idx = jnp.arange(tiles.shape[0])[:, None, None]
            tiles = jnp.where(idx < n, tiles, jnp.uint8(fill))
            need = gw * gh
            if need > tiles.shape[0]:
                pad = jnp.full((need - tiles.shape[0],) + tiles.shape[1:],
                               fill, jnp.uint8)
                tiles = jnp.concatenate([tiles, pad])
            return tiles[:need]

        def assemble_gather(ty, tu, tv, audio, gains):
            # cross-chip tile gather (SURVEY §5.7): tiles total one canvas
            # of bytes, so this is one small all_gather; every device
            # assembles the wall (replicated output)
            ty = jax.lax.all_gather(ty, self.axis, tiled=True)
            tu = jax.lax.all_gather(tu, self.axis, tiled=True)
            tv = jax.lax.all_gather(tv, self.axis, tiled=True)
            wall_y = rows_assemble(blank_fix(ty, 0), gh, gw, th, tw)
            wall_u = rows_assemble(blank_fix(tu, 128), gh, gw, th // 2,
                                   tw // 2)
            wall_v = rows_assemble(blank_fix(tv, 128), gh, gw, th // 2,
                                   tw // 2)
            return wall_y, wall_u, wall_v, mix_audio(audio, gains)

        assemble = assemble_aligned if self.aligned else assemble_gather

        def local_step(ys, us, vs, audio, gains, unis):
            ty, tu, tv = jax.vmap(scale_one)(ys, us, vs, unis)
            return assemble(ty, tu, tv, audio, gains)

        def local_step_plan(ys, us, vs, audio, gains):
            ty, tu, tv = scale_y420p_batch(ys, us, vs, self._plan)
            return assemble(ty, tu, tv, audio, gains)

        spec_s = P(self.axis)
        out_v = spec_s if self.aligned else P()
        # gather path: outputs ARE replicated (all_gather + psum) but the
        # varying-axis inference can't see through the assembly reshapes;
        # skip the static check there
        kw = {} if self.aligned else {"check_vma": False}
        shard = jax.shard_map(
            local_step, mesh=self.mesh,
            in_specs=(spec_s, spec_s, spec_s, spec_s, spec_s, spec_s),
            out_specs=(out_v, out_v, out_v, P()), **kw)
        shard_plan = jax.shard_map(
            local_step_plan, mesh=self.mesh,
            in_specs=(spec_s, spec_s, spec_s, spec_s, spec_s),
            out_specs=(out_v, out_v, out_v, P()), **kw)
        self._step_plan = jax.jit(shard_plan)
        return jax.jit(shard)

    # --- step -------------------------------------------------------------
    def shard(self, array):
        """Place a [N, ...] host array sharded over the stream axis,
        zero-padding N up to the mesh-divisible padded count."""
        array = jnp.asarray(array)
        if array.shape[0] != self.n_pad:
            pad = jnp.zeros((self.n_pad - array.shape[0],) + array.shape[1:],
                            array.dtype)
            array = jnp.concatenate([array, pad])
        return jax.device_put(array, NamedSharding(self.mesh, P(self.axis)))

    def default_uniforms(self):
        """Identity full-cell uniforms for every stream, sharded."""
        uni = identity_uniforms(self.stream_size, self.tile).pack()
        return self.shard(jnp.broadcast_to(jnp.asarray(uni),
                                           (self.n_pad, uni.shape[0])))

    def default_gains(self):
        """Unity gains for real streams, zero for padded blanks."""
        return self.shard((np.arange(self.n_pad)
                           < self.n_streams).astype(np.float32))

    def step(self, ys, us, vs, audio, gains=None, uniforms=None):
        """One wall tick.  ys/us/vs: [N, ...] u8 planes; audio: [N, samples]
        s16; gains: [N] f32; uniforms: optional [N, UNIFORM_WIDTH] per-cell
        composite uniforms.  Returns (wall_y, wall_u, wall_v, mixed).

        Without custom uniforms, cells run the matmul-sampler fast path
        (ops/matscale.py); per-cell uniforms use the general composite."""
        if gains is None:
            gains = self.default_gains()
        if uniforms is None and self._plan is not None:
            return self._step_plan(ys, us, vs, audio, gains)
        if uniforms is None:
            uniforms = self.default_uniforms()
        return self._step(ys, us, vs, audio, gains, uniforms)
