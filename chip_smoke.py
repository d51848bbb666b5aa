"""Smoke test of the live station on one NVIDIA GPU.

Drives the system's main path once through the library's own entry points,
at the size users run, and checks every device program on that path
against the plain numpy reference (``ops/golden.py`` and its like):

  device   JAX sees a GPU (there is no CPU fallback); prints the card's
           name and power limit, the JAX version and the compile cache in
           use, and builds the native helpers in ``csrc/``
  station  four seeded 1080p30 publishers -> RTMP ingest -> decode ->
           Composer -> encode -> RTMP egress for 60+ video ticks: every
           tick emits a frame, audio reaches egress, and composited frames
           match ``golden.composite_stack`` on the same decoded inputs
  parity   every device program that remains, at real widths, against
           its reference (each tolerance is printed beside its check)

``--four-cards`` runs only the mixing wall sharded over a four-GPU mesh
and compares it with the same wall on one GPU.

Codec: the card's machine has no FFmpeg development libraries, so the
in-process libav shim (``csrc/libsvav.so``) does not build there.  The
station therefore runs the stored-raw codec of ``tests/mock_ffmpeg.py``
through the subprocess backend: real Annex-B / ADTS framing, lossless
planes.

Run from the repository root:

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # four GPUs of one host

Everything runs in this one process, so one JAX process holds each card.
The last line printed is one JSON object; the exit code is 0 only when
every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MOCK_FFMPEG = os.path.join(REPO, "tests", "mock_ffmpeg.py")
FHD = (1920, 1080)


class SmokeError(AssertionError):
    pass


def log(*args) -> None:
    print(*args, flush=True)


def _even(v: float) -> int:
    return max(2, int(round(v / 2.0)) * 2)


def _lsb_errors(out, ref):
    """(max |out - ref|, count of pixels above 1 LSB) over plane pairs."""
    worst, above = 0, 0
    for o, r in zip(out, ref):
        o = np.asarray(o)
        r = np.asarray(r)
        if o.shape != r.shape:
            raise SmokeError(f"shape {o.shape} != reference {r.shape}")
        e = np.abs(o.astype(np.int64) - r.astype(np.int64))
        worst = max(worst, int(e.max()) if e.size else 0)
        above += int((e > 1).sum())
    return worst, above


def assert_lsb(name: str, out, ref) -> None:
    """The composite contract: <= 1 LSB, zero pixels above."""
    worst, above = _lsb_errors(out, ref)
    log(f"parity {name}: max err {worst} LSB, {above} px above 1 "
        f"(tolerance <= 1 LSB, 0 px above)")
    if worst > 1 or above:
        raise SmokeError(f"{name}: max err {worst}, {above} px above 1 LSB")


def assert_exact(name: str, out, ref) -> None:
    out, ref = np.asarray(out), np.asarray(ref)
    if out.shape != ref.shape or not np.array_equal(out, ref):
        bad = (int((out != ref).sum()) if out.shape == ref.shape
               else "shape")
        raise SmokeError(f"{name}: not exact ({bad} differ)")
    log(f"parity {name}: exact (tolerance: bit-equal)")


def _y420p(rng, w: int, h: int, smooth: bool = False):
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        ph = rng.uniform(0, 6.28)
        y = 127 + 80 * np.sin(xx / 23.0 + ph) * np.cos(yy / 17.0)
        c = y[::2, ::2]
        return [np.clip(y, 0, 255).astype(np.uint8),
                np.clip(c * 0.8 + 25, 0, 255).astype(np.uint8),
                np.clip(255 - c, 0, 255).astype(np.uint8)]
    return [rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8)]


# --------------------------------------------------------------------------
# device
# --------------------------------------------------------------------------

def card_lines():
    """``name, power.limit`` for each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def phase_device(n_cards: int = 1):
    """The GPU is there and the native helpers build; returns the device
    record of the final JSON line."""
    import jax

    from swiftvideo_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SmokeError(f"no GPU: JAX's first device is {devices[0]} "
                         f"(platform {platform!r}); this smoke test needs "
                         "an NVIDIA GPU and has no CPU fallback")
    if len(devices) < n_cards:
        raise SmokeError(f"need {n_cards} GPUs, JAX sees {len(devices)}")
    cache = enable_compile_cache()
    for line in card_lines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
        f"{len(devices)} device(s); compile cache {cache}")
    build = subprocess.run(
        ["make", "-C", os.path.join(REPO, "csrc"), "libsvbitstream.so",
         "libsvrtmp.so"], capture_output=True, text=True, timeout=300)
    if build.returncode:
        raise SmokeError("make -C csrc failed:\n" + build.stdout[-2000:]
                         + build.stderr[-2000:])
    log("csrc: built libsvbitstream.so libsvrtmp.so")
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}


# --------------------------------------------------------------------------
# station
# --------------------------------------------------------------------------

@contextlib.contextmanager
def stored_raw_codec():
    """Route avc/aac through the subprocess backend and the stored-raw
    codec of tests/mock_ffmpeg.py, restoring the environment after."""
    keys = ("SWIFTVIDEO_FFMPEG", "SV_CODEC_BACKEND")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["SWIFTVIDEO_FFMPEG"] = MOCK_FFMPEG
    os.environ["SV_CODEC_BACKEND"] = "subprocess"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def raw_frame_buffer(pub, frames: int = 16) -> None:
    """Let a live publisher queue ``frames`` 1080p stored-raw frames (3 MB
    each) before it drops media: asyncio's default 64 KiB high-water mark
    is sized for coded video and would drop nearly every raw frame."""
    pub.conn.transport.set_write_buffer_limits(
        high=frames * FHD[0] * FHD[1] * 3 // 2)


def _as_list(box):
    if not box.is_just():
        return []
    v = box.value()
    return v if isinstance(v, list) else [v]


def _encode_publisher(name, size, n_frames, rate, seed):
    """One publisher's pre-encoded media: moving seeded frames at 30 fps
    and a stereo tone at ``rate`` Hz, through the codec layer."""
    from swiftvideo_tpu.codec.codecs import AudioEncoder, VideoEncoder
    from swiftvideo_tpu.core import TimePoint
    from swiftvideo_tpu.media import (MediaFormat, PixelFormat,
                                      create_picture_sample)
    from swiftvideo_tpu.media.audio import AudioFormat, AudioSample

    w, h = size
    rng = np.random.default_rng(seed)
    base = _y420p(rng, w, h)
    venc = VideoEncoder(MediaFormat.avc)
    video = []
    for i in range(n_frames):
        pict = create_picture_sample(size, PixelFormat.y420p, asset_id=name,
                                     workspace_id="station")
        for k, plane in enumerate(base):
            pict.planes()[k][:] = np.roll(plane, (i * 2 >> k, i * 4 >> k),
                                          axis=(0, 1))
        video += _as_list(venc(pict.with_(pts=TimePoint(i * 1000, 30000))))
    video += venc.flush()
    venc.close()
    if len(video) != n_frames:
        raise SmokeError(f"{name}: {len(video)}/{n_frames} coded frames")

    aenc = AudioEncoder(MediaFormat.aac, frame_size=1024)
    audio = []
    n_samples = int(n_frames * rate / 30)
    freq = 220.0 * (1 + seed % 4)
    t = np.arange(n_samples) / rate
    pcm = (np.sin(2 * np.pi * freq * t) * 3000).astype(np.int16)
    pcm = np.repeat(pcm, 2)                    # stereo, interleaved
    for k in range(0, n_samples - 1023, 1024):
        audio += _as_list(aenc(AudioSample(
            buffers=(pcm[2 * k:2 * (k + 1024)],), frequency=rate,
            channels=2, format=AudioFormat.s16i, sample_count=1024,
            id_asset=name, id_workspace="station",
            pts_value=TimePoint(k, rate))))
    audio += aenc.flush()
    aenc.close()
    return video, audio


def station_composition(size):
    """A 4-element program: one full-frame camera and three pictures-in-
    picture, one at a 0.3 (non-integer) scale and one overlapping it.

    The pictures-in-picture sit at quarter-pixel offsets: an edge exactly
    on a pixel boundary is a knife edge whose pixel the f32 oracle and
    the device may assign to either side (a whole row off, not an LSB)."""
    from swiftvideo_tpu.core import TimePoint
    from swiftvideo_tpu.scene import Composition, Element, ElementState, Scene

    w, h = size

    def el(name, z, x, y, ew, eh, frac=0.25):
        return Element(name=name, z_index=z, initial_state=ElementState(
            pic_pos=(x + frac, y + frac), size=(ew + 2 * frac,
                                                 eh + 2 * frac)))

    return Composition(
        name="program", canvas_size=size,
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000), sample_rate=48000,
        channel_count=2,
        scenes=(Scene(name="main", elements=(
            el("full", 0, 0, 0, w, h, frac=0.0),
            el("pip1", 1, _even(0.62 * w), _even(0.06 * h),
               _even(0.3 * w), _even(0.3 * h)),
            el("pip2", 2, _even(0.5 * w), _even(0.2 * h),
               _even(0.25 * w), _even(0.25 * h)),
            el("pip3", 3, _even(0.05 * w), _even(0.7 * h),
               _even(0.2 * w), _even(0.2 * h)),
        )),), initial_scene="main")


def phase_station(size=FHD, ticks: int = 60, warmup: int = 10,
                  oracle_ticks: int = 5, seed: int = 0,
                  deadline_s: float = 30.0) -> dict:
    """Four publishers -> RTMP ingest -> decode -> Composer -> encode ->
    RTMP egress.  Returns the station's counts and compose-time
    percentiles (wall clock)."""
    import asyncio

    with stored_raw_codec():
        return asyncio.run(_station(size, ticks, warmup, oracle_ticks, seed,
                                    deadline_s))


async def _station(size, ticks, warmup, oracle_ticks, seed, deadline_s):
    import asyncio
    import socket

    from swiftvideo_tpu.codec.codecs import (AudioDecoder, AudioEncoder,
                                             VideoDecoder, VideoEncoder)
    from swiftvideo_tpu.codec.transcode import flat
    from swiftvideo_tpu.compose import Composer
    from swiftvideo_tpu.core import (Bus, EventBox, StatsReport, StepClock,
                                     TimePoint, Tx, WallClock, asset_filter,
                                     seconds)
    from swiftvideo_tpu.media import MediaFormat, MediaType
    from swiftvideo_tpu.net.rtmp import Rtmp
    from swiftvideo_tpu.ops import composite, golden

    t_start = time.perf_counter()
    n_frames = warmup + ticks + 10
    rates = (48000, 48000, 48000, 44100)       # cam3 exercises the SRC
    cams = [f"cam{k}" for k in range(4)]
    media = [_encode_publisher(c, size, n_frames, r, seed * 10 + k)
             for k, (c, r) in enumerate(zip(cams, rates))]
    log(f"station: encoded {len(cams)} x {n_frames} frames of "
        f"{size[0]}x{size[1]} y420p + audio at {rates} Hz in "
        f"{time.perf_counter() - t_start:.1f} s")

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    frame = TimePoint(1000, 30000)
    clock = StepClock(TimePoint(480, 48000))
    audio_bus, picture_bus = Bus(clock), Bus(clock)
    comp = station_composition(size)
    composer = Composer(clock, workspace_id="station", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus)
    mixer = composer.video_mixer
    # the station runs on a StepClock: read the compose timer off a wall
    # clock instead, in one bucket that outlives the run
    wall = WallClock()
    mixer.stats = StatsReport(asset_id=mixer.asset_id(),
                              period=TimePoint(3600, 1), clock=wall)

    # record each tick's composite inputs for the oracle (the mixer calls
    # composite.composite_tick once per tick, then emits)
    inputs = []
    real_tick = composite.composite_tick

    def recording_tick(out_fmt, out_size, sources):
        inputs.append((out_fmt, out_size, sources)
                      if len(sources) == 4 else None)
        return real_tick(out_fmt, out_size, sources)

    emitted = []
    picked = []                           # (tick, inputs, composited planes)

    def tap(sample):
        k = len(emitted)
        emitted.append(sample.pts())
        rec = inputs[k] if k < len(inputs) else None
        if (rec is not None and k >= warmup and len(picked) < oracle_ticks
                and k % 7 == 0):
            picked.append((k, rec, sample.planes()))
        return EventBox.just(sample)

    keep, decoders, received = [], [], []

    async def on_ingest(pub, sub):
        if sub is not None:
            name = sub.play_path()
            vdec, adec = VideoDecoder(), AudioDecoder()
            decoders.extend([vdec, adec])

            def route(s, name=name, vdec=vdec, adec=adec):
                box, bus = ((adec(s), audio_bus)
                            if s.media_type == MediaType.audio
                            else (vdec(s), picture_bus))
                for item in _as_list(box):
                    bus.append(EventBox.just(item.with_(asset_id=name)))
                return EventBox.nothing(None)

            keep.append(sub >> Tx(route))
        return True

    async def on_egress(pub, sub):
        if sub is not None:
            keep.append(sub >> Tx(
                lambda s: (received.append(s.media_type),
                           EventBox.nothing(None))[1]))
        return True

    port_in, port_out = free_port(), free_port()
    ingest = Rtmp(clock, on_connection=on_ingest)
    await ingest.serve("127.0.0.1", port_in)
    egress = Rtmp(clock, on_connection=on_egress)
    await egress.serve("127.0.0.1", port_out)
    out_pub, _ = await Rtmp(clock).connect(
        f"rtmp://127.0.0.1:{port_out}/live/program",
        publish_to_peer=True, max_attempts=3, retry_delay=0.2)
    raw_frame_buffer(out_pub)
    # a 0.5 s GOP: the egress publisher discards video until it has both
    # stream descriptions, and resumes at the next keyframe
    venc = VideoEncoder(MediaFormat.avc, keyframe_interval_s=0.5)
    aenc = AudioEncoder(MediaFormat.aac, frame_size=1024)

    def to_egress(s):
        out_pub.apply(EventBox.just(s))
        return EventBox.nothing(None)

    keep.append(picture_bus.subscribe(
        asset_filter(comp.name) >> Tx(tap) >> flat(venc)
        >> flat(Tx(to_egress))))
    keep.append(audio_bus.subscribe(
        asset_filter(comp.name) >> flat(aenc) >> flat(Tx(to_egress))))
    for cam, element in zip(cams, ("full", "pip1", "pip2", "pip3")):
        composer.bind(cam, element)
    composite.composite_tick = recording_tick

    pubs = []
    for cam, (video, audio) in zip(cams, media):
        pub, _ = await Rtmp(clock).connect(
            f"rtmp://127.0.0.1:{port_in}/live/{cam}",
            publish_to_peer=True, max_attempts=3, retry_delay=0.2)
        raw_frame_buffer(pub)
        pubs.append((pub, video, audio, [0]))
    n_ticks = 0
    try:
        for _ in range(24):               # publishers' metadata grace
            clock.step()
            await asyncio.sleep(0)
        t_loop = time.perf_counter()
        t0 = clock.current()
        for i in range(n_frames):
            for pub, video, audio, aidx in pubs:
                pub.apply(EventBox.just(video[i]))
                while (aidx[0] < len(audio)
                       and seconds(audio[aidx[0]].pts()) * 30 < i + 1):
                    pub.apply(EventBox.just(audio[aidx[0]]))
                    aidx[0] += 1
            # advance the clock by one frame of media time, at about the
            # wall-clock pace of a live feed
            while seconds(clock.current() - t0) * 30 < i + 1:
                clock.step()
                await asyncio.sleep(0.01)
            n_ticks = len(inputs)
            if n_ticks >= warmup + ticks and len(picked) >= oracle_ticks:
                break
        log(f"station: published {i + 1} frames per camera, {n_ticks} "
            f"ticks in {time.perf_counter() - t_loop:.1f} s")
        # drain with the clock held until egress stops receiving.  Live
        # publishers drop frames their peer cannot take in time (RTMP
        # backpressure), so egress may count fewer frames than emitted.
        t_drain = time.perf_counter()
        seen, t_seen = -1, t_drain
        while time.perf_counter() - t_seen < 1.0 \
                and time.perf_counter() - t_drain < deadline_s:
            if len(received) != seen:
                seen, t_seen = len(received), time.perf_counter()
            await asyncio.sleep(0.01)
        n_ticks = len(inputs)
    finally:
        composite.composite_tick = real_tick
        out_pub.close()
        for pub, *_ in pubs:
            pub.close()
        await ingest.close()
        await egress.close()
        composer.close()
        for d in decoders:
            d.close()
        venc.close()
        aenc.close()
        wall.close()

    checked = []
    for k, (out_fmt, out_size, sources), planes in picked:
        host = [([np.asarray(p) for p in pl], fmt, uni)
                for pl, fmt, uni in sources]
        ref = golden.composite_stack(out_fmt, out_size, host)
        checked.append((k, _lsb_errors(planes, ref)))
    compose = np.asarray(mixer.stats.sample_values("mix.video.compose"))
    n_video = received.count(MediaType.video)
    n_audio = received.count(MediaType.audio)
    res = {"ticks": n_ticks, "emitted": len(emitted),
           "egress_video": n_video, "egress_audio": n_audio,
           "oracle_ticks": [k for k, _ in checked],
           "compose_p50_ms": float(np.percentile(compose, 50) * 1e3)
           if compose.size else None,
           "compose_p99_ms": float(np.percentile(compose, 99) * 1e3)
           if compose.size else None,
           "seconds": time.perf_counter() - t_start}
    log(f"station: {n_ticks} video ticks, {len(emitted)} frames emitted, "
        f"{n_video} video + {n_audio} audio packets at egress")
    for k, (worst, above) in checked:
        log(f"parity station tick {k}: max err {worst} LSB, {above} px "
            f"above 1 (tolerance <= 1 LSB, 0 px above)")
    if n_ticks < warmup + ticks:
        raise SmokeError(f"only {n_ticks} video ticks (< {warmup + ticks})")
    if len(emitted) != n_ticks or compose.size != n_ticks:
        raise SmokeError(f"{n_ticks} ticks but {len(emitted)} frames "
                         f"emitted ({compose.size} compose timings)")
    if n_audio == 0 or n_video == 0:
        raise SmokeError(f"egress got {n_video} video and {n_audio} audio "
                         "packets")
    if len(checked) < oracle_ticks:
        raise SmokeError(f"only {len(checked)} ticks had all four sources "
                         f"for the oracle (< {oracle_ticks})")
    bad = [(k, e) for k, e in checked if e[0] > 1 or e[1]]
    if bad:
        raise SmokeError(f"composited frames off the oracle: {bad}")
    return res


# --------------------------------------------------------------------------
# parity
# --------------------------------------------------------------------------

def check_tick_programs(size=FHD, seed: int = 1) -> None:
    """The mixer's XLA tick programs, 4 sources, y420p / nv12 / nv21
    targets: a uniform quadrant scene (batched-boxed fold) and a mixed
    scene with an RGBA overlay and a rotated source (boxed fold; the
    rotated source through both the exact gather and the warp)."""
    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import composite, golden, rect_uniforms

    w, h = size
    rng = np.random.default_rng(seed)
    quad = []
    for s in range(4):
        quad.append((_y420p(rng, w, h), PixelFormat.y420p, rect_uniforms(
            (w, h), (w, h), x=(s % 2) * w / 2 + 0.3 * w / 640,
            y=(s // 2) * h / 2 + 0.7 * h / 360, w=w / 2, h=h / 2,
            opacity=0.9, fill_color=(0.1, 0.2, 0.3, 0.5))))
    ref = golden.composite_stack(PixelFormat.y420p, size, quad)
    assert_lsb("tick y420p quadrants (batched-boxed)",
               composite.composite_stack_batched_boxed(size, quad), ref)
    for fmt in (PixelFormat.nv12, PixelFormat.nv21):
        assert_lsb(f"tick {fmt.name} quadrants (boxed)",
                   composite.composite_stack_boxed(fmt, size, quad),
                   golden.composite_stack(fmt, size, quad))

    pw, ph = _even(0.35 * w), _even(0.35 * h)
    ow, oh = _even(0.25 * w), _even(0.125 * h)
    rw, rh = _even(0.5 * w), _even(0.5 * h)
    rgba = rng.integers(0, 256, (oh, ow, 4), np.uint8)
    mixed = [
        (_y420p(rng, w, h), PixelFormat.y420p,
         rect_uniforms((w, h), (w, h), x=0, y=0, w=w, h=h)),
        (_y420p(rng, pw, ph), PixelFormat.y420p,
         rect_uniforms((pw, ph), (w, h), x=0.1 * w + 0.4, y=0.1 * h + 0.3,
                       w=0.3 * w, h=0.3 * h, opacity=0.85)),
        ([rgba], PixelFormat.RGBA,
         rect_uniforms((ow, oh), (w, h), x=0.6 * w + 0.5, y=0.75 * h + 0.25,
                       w=ow, h=oh, opacity=0.9,
                       fill_color=(0.2, 0.1, 0.5, 0.4))),
        (_y420p(rng, rw, rh, smooth=True), PixelFormat.y420p,
         rect_uniforms((rw, rh), (w, h), x=0.35 * w + 0.4, y=0.3 * h + 0.7,
                       w=0.45 * w, h=0.45 * h, rotation=0.35,
                       opacity=0.9)),
    ]
    for fmt in (PixelFormat.y420p, PixelFormat.nv12, PixelFormat.nv21):
        ref = golden.composite_stack(fmt, size, mixed)
        assert_lsb(f"tick {fmt.name} rgba+rotated (exact gather)",
                   composite.composite_stack_boxed(fmt, size, mixed,
                                                   exact_rotation=True), ref)
        out = composite.composite_stack_boxed(fmt, size, mixed,
                                              exact_rotation=False)
        errs = np.concatenate([
            np.abs(np.asarray(o).astype(np.int64)
                   - np.asarray(r).astype(np.int64)).ravel()
            for o, r in zip(out, ref)])
        p90, frac4 = float(np.percentile(errs, 90)), float((errs > 4).mean())
        log(f"parity tick {fmt.name} rgba+rotated (warp): p90 err {p90} "
            f"LSB, {frac4:.5f} of px above 4 (tolerance: p90 <= 1, < 1% "
            f"above 4, the cascade filter's documented bound on smooth "
            f"content)")
        if p90 > 1 or frac4 >= 0.01:
            raise SmokeError(f"warp tick {fmt.name}: p90 {p90}, "
                             f"{frac4:.4f} above 4")


def check_rgba_convert(src=(1280, 720), out=(640, 360),
                       seed: int = 2) -> None:
    """y420p -> RGBA convert + 2:1 downscale through the mixer's tick."""
    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import composite, golden, identity_uniforms

    rng = np.random.default_rng(seed)
    srcs = [(_y420p(rng, *src), PixelFormat.y420p,
             identity_uniforms(src, out))]
    assert_lsb(f"rgba convert {src[0]}x{src[1]}->{out[0]}x{out[1]}",
               composite.composite_tick(PixelFormat.RGBA, out, srcs),
               golden.composite_stack(PixelFormat.RGBA, out, srcs))


def check_ladder(src=FHD, rungs=((1280, 720), (854, 480), (640, 360)),
                 seed: int = 3) -> None:
    """matscale's banded-matmul ladder (Precision.HIGH: one TF32 pass on
    the H100) against the oracle's separable bilinear."""
    import jax

    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import golden, identity_uniforms
    from swiftvideo_tpu.ops.matscale import plan_scale, scale_y420p

    w, h = src
    rng = np.random.default_rng(seed)
    planes = _y420p(rng, w, h)
    for rung in rungs:
        rw, rh = rung[0] // 2 * 2, rung[1] // 2 * 2
        uni = identity_uniforms((w, h), (rw, rh))
        plan = plan_scale(uni, (rw, rh), (h, w))
        if plan is None:
            raise SmokeError(f"no scale plan for {rw}x{rh}")
        out = jax.jit(lambda p, plan=plan: scale_y420p(p, plan))(
            tuple(planes))
        assert_lsb(f"ladder {w}x{h}->{rw}x{rh} (matmul precision HIGH)",
                   out, golden.composite_stack(
                       PixelFormat.y420p, (rw, rh),
                       [(planes, PixelFormat.y420p, uni)]))


def check_resampler(channels: int = 128, n: int = 44100,
                    seed: int = 4) -> None:
    """Polyphase 44.1 -> 48 kHz, device (f32, precision 'highest')
    against the numpy reference."""
    from swiftvideo_tpu.ops.resample import PolyphaseResampler

    x = np.random.default_rng(seed).standard_normal(
        (channels, n)).astype(np.float32)
    a = PolyphaseResampler(44100, 48000, channels).process(x)
    b = PolyphaseResampler(44100, 48000, channels,
                           use_device=True).process(x)
    if a.shape != b.shape:
        raise SmokeError(f"resampler shapes {a.shape} != {b.shape}")
    err = float(np.abs(a - b).max())
    log(f"parity resampler 44.1->48 kHz x{channels} ch: max abs err "
        f"{err:.3g} (tolerance < 1e-4, unit amplitude)")
    if err >= 1e-4:
        raise SmokeError(f"resampler err {err}")


def check_audio_mix(n: int = 1920, sources: int = 6, seed: int = 5) -> None:
    """The s16 saturating fold, aligned and windowed: bit-exact."""
    from swiftvideo_tpu.ops.audio import (apply_mix_s16, mix_s16_device,
                                          mix_s16_device_windowed)

    rng = np.random.default_rng(seed)
    inputs = rng.integers(-20000, 20000, (sources, n)).astype(np.int16)
    gains = rng.uniform(0.1, 2.0, (sources, 2)).astype(np.float32)
    host = np.zeros(n, np.int16)
    for i in range(sources):
        apply_mix_s16(inputs[i], gains[i], host)
    assert_exact("audio mix s16", mix_s16_device(inputs, gains), host)

    base = rng.integers(-30000, 30000, n).astype(np.int16)
    expect = base.copy()
    win = np.zeros((sources, n), np.int16)
    starts = np.zeros(sources, np.int32)
    ends = np.zeros(sources, np.int32)
    for k in range(sources):
        size = int(rng.integers(n // 4, n + n // 4))
        data = rng.integers(-32768, 32767, size).astype(np.int16)
        b_off = int(rng.integers(0, n - n // 20))
        i_off = int(rng.integers(0, size - size // 20))
        apply_mix_s16(data, gains[k], expect, backing_start=b_off,
                      input_start=i_off)
        m = min(n - b_off, size - i_off)
        win[k, b_off:b_off + m] = data[i_off:i_off + m]
        starts[k], ends[k] = b_off, b_off + m
    assert_exact("audio mix s16 windowed",
                 mix_s16_device_windowed(win, gains, starts, ends,
                                         base=base), expect)


def _wall_inputs(n, stream, seed, samples):
    rng = np.random.default_rng(seed)
    sw, sh = stream
    ys = rng.integers(0, 256, (n, sh, sw), np.uint8)
    us = rng.integers(0, 256, (n, sh // 2, sw // 2), np.uint8)
    vs = rng.integers(0, 256, (n, sh // 2, sw // 2), np.uint8)
    audio = rng.integers(-2000, 2000, (n, samples * 2)).astype(np.int16)
    return ys, us, vs, audio


def _run_wall(devices, n, stream, canvas, inputs, samples):
    import jax

    from swiftvideo_tpu.parallel import MixingWall, make_mesh

    wall = MixingWall(make_mesh(devices), n_streams=n, stream_size=stream,
                      canvas_size=canvas, audio_samples=samples)
    args = [wall.shard(a) for a in inputs]
    out = wall.step(*args)
    jax.block_until_ready(out)
    return wall, args, out


def check_wall(n: int = 64, stream=FHD, canvas=(1920, 1088),
               samples: int = 800, seed: int = 6) -> None:
    """The single-card MixingWall against the oracle on sampled tiles;
    its audio mix against the exact host sum."""
    import jax

    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import golden, identity_uniforms

    inputs = _wall_inputs(n, stream, seed, samples)
    wall, _, (wy, wu, wv, mixed) = _run_wall(jax.devices()[:1], n, stream,
                                             canvas, inputs, samples)
    ys, us, vs, audio = inputs
    gw, _ = wall.grid_wh
    tw, th = wall.tile
    uni = identity_uniforms(stream, (tw, th))
    wy, wu, wv = np.asarray(wy), np.asarray(wu), np.asarray(wv)
    for s in sorted({0, gw - 1, gw + 1, n - 1}):
        r, c = divmod(s, gw)
        ref = golden.composite_stack(
            PixelFormat.y420p, (tw, th),
            [([ys[s], us[s], vs[s]], PixelFormat.y420p, uni)])
        got = (wy[r * th:(r + 1) * th, c * tw:(c + 1) * tw],
               wu[r * th // 2:(r + 1) * th // 2,
                  c * tw // 2:(c + 1) * tw // 2],
               wv[r * th // 2:(r + 1) * th // 2,
                  c * tw // 2:(c + 1) * tw // 2])
        assert_lsb(f"wall {n}x{stream[0]}x{stream[1]} tile {s} (matmul "
                   f"precision HIGH)", got, ref)
    expect = np.clip(audio.astype(np.int64).sum(0), -32768, 32767)
    assert_exact(f"wall {n}-stream audio mix", mixed, expect)


def check_motion(size=FHD, crop=(256, 128), seed: int = 7) -> None:
    """Motion search, exact SAD and SSD: candidate-exact against the
    scalar oracles on a crop, and translation recovery at full size
    (block 16, search 64; u8 operands are exact in bf16 and the
    cross-term sums stay below 2^24, so f32 accumulation is exact)."""
    from swiftvideo_tpu.ops import motion

    w, h = size
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 255, (h, w), np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-12, 12, ref.shape),
                  0, 255).astype(np.uint8)
    cw, ch = crop
    c, r = cur[:ch, :cw], ref[:ch, :cw]
    assert_exact(f"motion SAD {cw}x{ch} vs oracle (integer arithmetic)",
                 motion.me_fullsearch_device(c, r, 16, 64),
                 motion.me_fullsearch_golden(c, r, 16, 64))
    assert_exact(f"motion SSD {cw}x{ch} vs oracle (bf16 operands, f32 "
                 f"accumulation)",
                 motion.me_fullsearch_device(c, r, 16, 64, metric="ssd"),
                 motion.me_ssd_golden(c, r, 16, 64))
    dy, dx = 6, 4
    moved = np.roll(ref, (dy, dx), axis=(0, 1))
    for metric in ("sad", "ssd"):
        mv = np.asarray(motion.me_fullsearch_device(moved, ref, 16, 64,
                                                    metric=metric))
        inner = mv[2:-2, 2:-2]
        ex = int(round((dx / 32 * 0.5 + 0.5) * 255))
        ey = int(round((dy / 32 * 0.5 + 0.5) * 255))
        ok = bool(np.all(inner[..., 0] == ex) and np.all(inner[..., 2] == ey))
        log(f"parity motion {metric.upper()} {w}x{h} translation "
            f"({dx},{dy}): {'recovered' if ok else 'MISSED'} on all "
            f"{inner.shape[0] * inner.shape[1]} interior blocks "
            f"(tolerance: exact)")
        if not ok:
            raise SmokeError(f"motion {metric} missed the translation")


PARITY_CHECKS = (check_tick_programs, check_rgba_convert, check_ladder,
                 check_resampler, check_audio_mix, check_wall, check_motion)


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

_COLLECTIVE = re.compile(
    r"= (.*?) (all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")


def _collectives(wall, args):
    """The wall step's collectives as XLA compiled them: (audio, video)
    lists of ``op result-shape`` — video planes are u8, the audio mix is
    f32 — and the psum count of the jaxpr."""
    import jax
    step_args = (*args, wall.default_gains())
    hlo = wall._step_plan.lower(*step_args).compile().as_text()
    audio, video = [], []
    for shape, op in _COLLECTIVE.findall(hlo):
        (video if "u8[" in shape else audio).append(
            f"{op} {shape}")
    psums = str(jax.make_jaxpr(wall._step_plan)(*step_args)).count("psum")
    return audio, video, psums


def check_wall_mesh(devices, n: int = 64, stream=FHD,
                    canvas=(1920, 1088), samples: int = 800,
                    aligned: bool = True, seed: int = 8) -> None:
    """The wall over a mesh of ``devices`` equals the same wall on one
    device: video bit-equal, audio equal.  The aligned layout runs no
    video collective and one audio psum; the padded layout gathers."""
    import jax

    inputs = _wall_inputs(n, stream, seed, samples)
    wall, args, out = _run_wall(devices, n, stream, canvas, inputs,
                                samples)
    if wall.aligned != aligned:
        raise SmokeError(f"{n} streams: aligned={wall.aligned}, "
                         f"expected {aligned}")
    audio, video, psums = _collectives(wall, args)
    spread = sorted({d.id for d in out[0].sharding.device_set})
    shard_devs = {s.device.id for s in args[0].addressable_shards}
    log(f"wall mesh {len(devices)} devices, {n} streams "
        f"({'aligned' if aligned else 'padded + gather'}): {psums} psum "
        f"in the program; compiled collectives: audio {audio}, video "
        f"{video}; output on devices {spread}; input shards on "
        f"{len(shard_devs)} devices")
    if len(shard_devs) != len(devices) or len(spread) != len(devices):
        raise SmokeError("the wall did not spread over every device")
    if psums != 1 or not any(a.startswith("all-reduce") for a in audio):
        raise SmokeError(f"expected one audio psum, got {psums} ({audio})")
    if aligned and video:
        raise SmokeError(f"aligned wall ran video collectives: {video}")
    if not aligned and not any(v.startswith("all-gather") for v in video):
        raise SmokeError(f"padded wall ran no tile all-gather: {video}")
    _, _, one = _run_wall(jax.devices()[:1], n, stream, canvas, inputs,
                          samples)
    for name, a, b in zip(("y", "u", "v"), out[:3], one[:3]):
        assert_exact(f"wall {len(devices)}-device vs 1-device {n} streams "
                     f"plane {name}", a, b)
    assert_exact(f"wall {len(devices)}-device vs 1-device {n} streams "
                 f"audio", out[3], one[3])


def four_card_checks(devices) -> None:
    check_wall_mesh(devices, 64, canvas=(1920, 1088), aligned=True)
    check_wall_mesh(devices, 50, canvas=(1920, 1092), aligned=False)


# --------------------------------------------------------------------------

def _run_phase(name, fn, failures):
    t0 = time.perf_counter()
    log(f"== {name}")
    try:
        res = fn()
        log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")
        return res
    except Exception as exc:  # noqa: BLE001 - every failure is reported
        traceback.print_exc()
        log(f"== {name}: FAILED ({time.perf_counter() - t0:.1f} s): {exc}")
        failures.append(name)
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mixing wall and its "
                         "1-GPU comparison")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    failures = []
    device = _run_phase("device", lambda: phase_device(n_cards), failures)
    if device is None:
        return 1
    import jax

    if args.four_cards:
        _run_phase("four-cards wall",
                   lambda: four_card_checks(jax.devices()[:4]), failures)
        device["count"] = 4
    else:
        station = _run_phase("station", phase_station, failures)
        if station is not None:
            card = card_lines()[0]
            log(f"station compose time (mix.video.compose, wall clock): "
                f"p50 {station['compose_p50_ms']:.3f} ms, p99 "
                f"{station['compose_p99_ms']:.3f} ms on {card} "
                f"(information, not a claim)")
        for check in PARITY_CHECKS:
            _run_phase(f"parity {check.__name__}", check, failures)
        device["count"] = len(jax.devices())
    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
