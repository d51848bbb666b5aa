"""Sharded mixing wall on the virtual 8-device CPU mesh (conftest)."""

import jax.numpy as jnp
import numpy as np
import pytest

from swiftvideo_tpu.parallel import MixingWall


def test_wall_16_streams_over_8_devices(mesh8):
    mesh = mesh8
    n = 64
    sw, sh = 64, 36
    wall = MixingWall(mesh, n_streams=n, stream_size=(sw, sh),
                      canvas_size=(128, 96), audio_samples=48, channels=2)
    rng = np.random.default_rng(0)
    ys = wall.shard(jnp.asarray(
        rng.integers(0, 256, (n, sh, sw), np.int64).astype(np.uint8)))
    us = wall.shard(jnp.full((n, sh // 2, sw // 2), 100, jnp.uint8))
    vs = wall.shard(jnp.full((n, sh // 2, sw // 2), 150, jnp.uint8))
    audio = wall.shard(jnp.full((n, 48 * 2), 100, jnp.int16))
    wy, wu, wv, mixed = wall.step(ys, us, vs, audio)
    assert wy.shape == (96, 128)
    assert wu.shape == (48, 64)
    assert mixed.shape == (48 * 2,)
    # audio: 64 streams x 100 = 6400
    assert np.all(np.asarray(mixed) == 6400)
    # wall tile (0,0) equals stream 0 scaled to 16x9 — sample a pixel
    y_host = np.asarray(wy)
    assert y_host.shape == (96, 128)
    # chroma passthrough: scaled chroma stays at the stream values
    assert abs(int(np.asarray(wu)[10, 10]) - 100) <= 1
    assert abs(int(np.asarray(wv)[10, 10]) - 150) <= 1


def test_wall_audio_saturates(mesh8):
    mesh = mesh8
    wall = MixingWall(mesh, n_streams=64, stream_size=(16, 16),
                      canvas_size=(64, 64), audio_samples=8)
    ys = wall.shard(jnp.zeros((64, 16, 16), jnp.uint8))
    us = wall.shard(jnp.full((64, 8, 8), 128, jnp.uint8))
    vs = wall.shard(jnp.full((64, 8, 8), 128, jnp.uint8))
    audio = wall.shard(jnp.full((64, 16), 30000, jnp.int16))
    _, _, _, mixed = wall.step(ys, us, vs, audio)
    assert np.all(np.asarray(mixed) == 32767)


def test_wall_tiles_match_oracle(mesh8):
    """Each wall tile must equal the golden oracle's convert+scale of its
    stream (identity uniforms, full-canvas element)."""
    from swiftvideo_tpu.media import PixelFormat
    from swiftvideo_tpu.ops import golden, identity_uniforms

    mesh = mesh8
    n, sw, sh = 64, 64, 36
    wall = MixingWall(mesh, n_streams=n, stream_size=(sw, sh),
                      canvas_size=(128, 96), audio_samples=8)
    rng = np.random.default_rng(3)
    ys_np = rng.integers(0, 256, (n, sh, sw), np.int64).astype(np.uint8)
    us_np = rng.integers(0, 256, (n, sh // 2, sw // 2), np.int64).astype(np.uint8)
    vs_np = rng.integers(0, 256, (n, sh // 2, sw // 2), np.int64).astype(np.uint8)
    wy, wu, wv, _ = wall.step(wall.shard(jnp.asarray(ys_np)),
                              wall.shard(jnp.asarray(us_np)),
                              wall.shard(jnp.asarray(vs_np)),
                              wall.shard(jnp.zeros((n, 16), jnp.int16)))
    wy = np.asarray(wy)
    tw, th = wall.tile
    uni = identity_uniforms((sw, sh), (tw, th))
    for s in (0, 7, 9, 63):  # corners + an interior stream
        row, col = s // 8, s % 8
        expect = golden.composite_stack(
            PixelFormat.y420p, (tw, th),
            [([ys_np[s], us_np[s], vs_np[s]], PixelFormat.y420p, uni)])
        got = wy[row * th:(row + 1) * th, col * tw:(col + 1) * tw]
        assert np.abs(got.astype(int) - expect[0].astype(int)).max() <= 1


def test_wall_per_stream_uniforms(mesh8):
    """Per-cell uniforms: one stream renders at half opacity into its tile,
    another with a fill-colored aspect inset."""
    from swiftvideo_tpu.ops import identity_uniforms, rect_uniforms

    mesh = mesh8
    n, sw, sh = 64, 32, 16
    wall = MixingWall(mesh, n_streams=n, stream_size=(sw, sh),
                      canvas_size=(128, 96), audio_samples=8)
    ys = wall.shard(jnp.full((n, sh, sw), 200, jnp.uint8))
    us = wall.shard(jnp.full((n, sh // 2, sw // 2), 128, jnp.uint8))
    vs = wall.shard(jnp.full((n, sh // 2, sw // 2), 128, jnp.uint8))
    audio = wall.shard(jnp.zeros((n, 16), jnp.int16))
    tw, th = wall.tile
    unis = np.stack([identity_uniforms((sw, sh), (tw, th)).pack()
                     for _ in range(n)])
    unis[0] = identity_uniforms((sw, sh), (tw, th), opacity=0.5).pack()
    uniforms = wall.shard(jnp.asarray(unis))
    wy, _, _, _ = wall.step(ys, us, vs, audio, uniforms=uniforms)
    y = np.asarray(wy)
    # stream 0's tile at half opacity over black: ~100; stream 1 full: ~200
    assert abs(int(y[th // 2, tw // 2]) - 100) <= 2
    assert abs(int(y[th // 2, tw + tw // 2]) - 200) <= 2


def test_wall_48_streams_6x8_grid_aligned(mesh8):
    """Rectangular 6x8 wall for 48 streams on 8 devices (VERDICT r2 #6):
    one wall row per device, aligned zero-collective video path."""
    mesh = mesh8
    n = 48
    wall = MixingWall(mesh, n_streams=n, stream_size=(32, 16),
                      canvas_size=(96, 64), grid=(6, 8), audio_samples=24)
    assert wall.aligned
    vals = np.arange(n, dtype=np.uint8)[:, None, None] * 5
    ys = wall.shard(jnp.broadcast_to(jnp.asarray(vals), (n, 16, 32)))
    us = wall.shard(jnp.full((n, 8, 16), 128, jnp.uint8))
    vs = wall.shard(jnp.full((n, 8, 16), 128, jnp.uint8))
    audio = wall.shard(jnp.full((n, 48), 10, jnp.int16))
    wy, wu, wv, mixed = wall.step(ys, us, vs, audio)
    assert wy.shape == (64, 96)
    assert np.all(np.asarray(mixed) == 10 * n)
    y = np.asarray(wy)
    # cell (r, c) holds stream r*6+c (constant fill survives scaling)
    for r, c in ((0, 0), (3, 4), (7, 5)):
        assert y[r * 8 + 4, c * 16 + 8] == (r * 6 + c) * 5


def test_wall_non_divisible_streams_gather_path(mesh8):
    """20 streams on 8 devices: padded to 24, 5x4 auto grid, cross-chip
    tile gather assembles a replicated canvas; blanks are black cells and
    contribute no audio."""
    mesh = mesh8
    n = 20
    wall = MixingWall(mesh, n_streams=n, stream_size=(32, 16),
                      canvas_size=(80, 32), audio_samples=24)
    assert not wall.aligned
    assert wall.grid_wh == (5, 4)
    vals = np.arange(n, dtype=np.uint8)[:, None, None] * 3 + 10
    ys = wall.shard(jnp.broadcast_to(jnp.asarray(vals), (n, 16, 32)))
    us = wall.shard(jnp.full((n, 8, 16), 90, jnp.uint8))
    vs = wall.shard(jnp.full((n, 8, 16), 160, jnp.uint8))
    audio = wall.shard(jnp.full((n, 48), 7, jnp.int16))
    wy, wu, wv, mixed = wall.step(ys, us, vs, audio)
    assert wy.shape == (32, 80)
    assert np.all(np.asarray(mixed) == 7 * n)   # padded streams: zero gain
    y, u = np.asarray(wy), np.asarray(wu)
    for r, c in ((0, 0), (2, 3), (3, 4)):
        assert y[r * 8 + 4, c * 16 + 8] == (r * 5 + c) * 3 + 10
    assert abs(int(u[2 * 4 + 2, 3 * 8 + 4]) - 90) <= 1


def test_wall_grid_too_small_raises(mesh8):
    mesh = mesh8
    with pytest.raises(ValueError):
        MixingWall(mesh, n_streams=48, stream_size=(32, 16),
                   canvas_size=(96, 64), grid=(4, 4))


def test_wall_fed_by_64_rtmp_ingest_sessions(mesh8):
    """BASELINE config 5's HOST shape end-to-end: 64 concurrent RTMP
    publishers into one server/event loop, each session's latest frame
    landing in a per-stream table that feeds the wall's shard step on
    the virtual 8-device mesh.  (Codec decode is proven separately via
    the mock-ffmpeg pipe suite; here each ingest payload deterministically
    seeds its stream's luma so tile content can be traced back to the
    session that produced it.)"""
    import asyncio
    import socket

    from swiftvideo_tpu.core import EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu.media.coded import (CodedMediaSample, MediaFormat,
                                            MediaType)
    from swiftvideo_tpu.net.rtmp import Rtmp

    n = 64
    sw, sh = 32, 16

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def ingest():
        clock = StepClock(TimePoint(16, 1000))
        latest, keep = {}, []

        async def on_connection(pub, sub):
            if sub is not None:
                name = sub.play_path()
                keep.append(sub >> Tx(
                    lambda s, name=name: (latest.__setitem__(name, s),
                                          EventBox.nothing(None))[1]))
            return True

        server = Rtmp(clock, on_connection=on_connection)
        await server.serve("127.0.0.1", port)
        pubs = []
        for k in range(n):
            client = Rtmp(clock)
            pub, _ = await client.connect(
                f"rtmp://127.0.0.1:{port}/wall/cam{k}",
                publish_to_peer=True, max_attempts=3, retry_delay=0.2)
            pubs.append(pub)
        for _ in range(14):
            clock.step()
            await asyncio.sleep(0)
        ts = TimePoint(0, 1000)
        for i in range(3):
            for k, pub in enumerate(pubs):
                body = bytearray(200)
                body[4] = 0x65
                body[5] = 3 * k + 2          # luma seed for this stream
                pub.apply(EventBox.just(CodedMediaSample(
                    buffer=bytes(body), pts_value=ts, dts_value=ts,
                    media_type=MediaType.video, media_format=MediaFormat.avc,
                    id_asset=f"cam{k}", id_workspace="w",
                    side={"config": bytes(48)})))
            ts = ts + TimePoint(16, 1000)
            clock.step()
            await asyncio.sleep(0)
        deadline = asyncio.get_event_loop().time() + 20.0
        while (len(latest) < n
               and asyncio.get_event_loop().time() < deadline):
            await asyncio.sleep(0)
        for pub in pubs:
            pub.close()
        await server.close()
        return latest

    latest = asyncio.run(ingest())
    assert len(latest) == n

    # per-stream frame table from the ingest sessions -> wall shard step
    seeds = np.array([latest[f"cam{k}"].data()[5] for k in range(n)],
                     np.uint8)
    ys_host = np.broadcast_to(seeds[:, None, None], (n, sh, sw)).copy()
    mesh = mesh8
    wall = MixingWall(mesh, n_streams=n, stream_size=(sw, sh),
                      canvas_size=(128, 64), audio_samples=16, channels=2)
    ys = wall.shard(jnp.asarray(ys_host))
    us = wall.shard(jnp.full((n, sh // 2, sw // 2), 128, jnp.uint8))
    vs = wall.shard(jnp.full((n, sh // 2, sw // 2), 128, jnp.uint8))
    audio = wall.shard(jnp.full((n, 16 * 2), 10, jnp.int16))
    wy, _, _, mixed = wall.step(ys, us, vs, audio)
    y_host = np.asarray(wy)
    assert y_host.shape == (64, 128)
    assert np.all(np.asarray(mixed) == 10 * n)
    # the wall is an 8x8 grid of 16x8 tiles; every tile must show ITS
    # session's seed (scaling a constant preserves it within 1 LSB)
    for k in range(n):
        r, c = divmod(k, 8)
        tile = y_host[r * 8:(r + 1) * 8, c * 16:(c + 1) * 16]
        assert abs(int(tile[4, 8]) - int(seeds[k])) <= 1, \
            f"tile {k}: {int(tile[4, 8])} vs seed {int(seeds[k])}"
