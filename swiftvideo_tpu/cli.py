"""Command-line surface: ``python -m swiftvideo_tpu <command> ...``.

The reference ships its user-facing flows as compiled example binaries
(/root/reference/Examples/Mixing/main.swift, Examples/Transcoding/
main.swift, Examples/RtmpServer/main.swift); this module exposes the
same flows as subcommands over the library so a user can drive them
without writing a graph by hand:

  mix        composition JSON -> composited frames (PNG dump)
  transcode  media file -> elementary-stream file(s) through the codec
             layer (Annex-B / IVF / Y4M video; ADTS / Ogg-Opus audio)
  serve      RTMP ingest server: accept publishers, count + optionally
             record their media
  probe      print stream parameters of an elementary/container file

Everything runs on the StepClock / WallClock graph runtime; device
compute runs on JAX's default device, the GPU where one is visible
(``SV_DEVICE=cpu`` forces CPU, mirroring the examples).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
from typing import List, Optional


def _device_setup() -> None:
    """For the commands that compute on the device: honour SV_DEVICE=cpu
    and keep compiled programs in the persistent cache.  (``serve`` never
    imports JAX, so its forked workers never open the device.)"""
    from .utils.compile_cache import enable_compile_cache

    if os.environ.get("SV_DEVICE", "") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()


# --------------------------------------------------------------------------
# mix
# --------------------------------------------------------------------------

def _default_composition():
    from .compose import Composition, Element, ElementState, Scene
    from .core import TimePoint

    return Composition(
        name="mix", canvas_size=(640, 360),
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000),
        scenes=(Scene(name="main", elements=(
            Element(name="background", initial_state=ElementState(
                pic_pos=(0, 0), size=(640, 360))),
            Element(name="pip", initial_state=ElementState(
                pic_pos=(400, 20), size=(220, 124)), z_index=1),
        )),),
        initial_scene="main")


def cmd_mix(args: argparse.Namespace) -> int:
    """Composition JSON -> Composer -> PNG frames (Examples/Mixing)."""
    _device_setup()
    import numpy as np

    from .compose import Composer, composition_from_json
    from .core import Bus, EventBox, StepClock, TimePoint, Tx
    from .media import PixelFormat, create_picture_sample
    from .ops import golden, identity_uniforms, make_compute_context

    if args.composition:
        with open(args.composition, "r", encoding="utf-8") as fh:
            comp = composition_from_json(fh.read())
    else:
        comp = _default_composition()
    os.makedirs(args.out, exist_ok=True)

    clock = StepClock(comp.audio_frame_duration)
    audio_bus, picture_bus = Bus(clock), Bus(clock)
    composer = Composer(clock, workspace_id=args.workspace,
                        composition=comp, audio_bus=audio_bus,
                        picture_bus=picture_bus,
                        compute_context=make_compute_context())

    frames: List = []
    sub = picture_bus.subscribe(Tx(
        lambda s: (frames.append(s), EventBox.just(s))[1]
        if s.asset_id() == comp.name else EventBox.nothing(None)))

    if not comp.scenes:
        raise SystemExit(f"composition {comp.name!r} has no scenes")
    want = comp.initial_scene or comp.scenes[0].name
    scene = next((s for s in comp.scenes if s.name == want), None)
    if scene is None:
        raise SystemExit(
            f"initial_scene {want!r} not found; scenes are "
            f"{[s.name for s in comp.scenes]}")
    for i, element in enumerate(scene.elements):
        size = element.initial_state.size
        if not (size and size[0] and size[1]):
            # ElementState defaults to (0.0, 0.0), which is truthy as a
            # tuple: elements with no explicit size fill the canvas
            size = comp.canvas_size
        size = (max(int(size[0]), 2) // 2 * 2, max(int(size[1]), 2) // 2 * 2)
        pict = create_picture_sample(size, PixelFormat.y420p,
                                     asset_id=element.name,
                                     workspace_id=args.workspace)
        y, x = np.mgrid[0:size[1], 0:size[0]]
        pict.planes()[0][:] = ((x * (i + 1) + y) % 256).astype(np.uint8)
        pict.planes()[1][:] = np.uint8(128 + (i * 37) % 100)
        pict.planes()[2][:] = np.uint8(128 - (i * 23) % 100)
        composer.bind(element.name, element.name)
        picture_bus.append(EventBox.just(pict))

    # tick budget: enough audio-clock steps to cover args.frames video
    # frames (exact rational ceiling — round() under-budgets whenever the
    # ratio is fractional, e.g. 10ms ticks vs 33.3ms frames) plus slack
    # for the mixer start-up delay
    num = args.frames * comp.frame_duration.value * \
        comp.audio_frame_duration.scale
    den = comp.frame_duration.scale * comp.audio_frame_duration.value
    budget = -(-num // den) + 64
    written = 0
    for _ in range(budget):
        clock.step()
        if len(frames) >= args.frames:
            break
    composer.close()
    del sub

    mixed = frames[:args.frames]
    for idx in range(0, len(mixed), max(1, args.every)):
        sample = mixed[idx]
        planes = [np.asarray(p) for p in sample.planes()]
        rgba = golden.composite_stack(
            PixelFormat.RGBA, sample.size(),
            [(planes, sample.pixel_format(),
              identity_uniforms(sample.size(), sample.size()))])[0]
        path = os.path.join(args.out, f"frame_{idx:05d}.png")
        import cv2

        cv2.imwrite(path, rgba[..., [2, 1, 0, 3]])
        written += 1
    print(f"mixed {len(mixed)} frames, wrote {written} PNGs to {args.out}")
    return 0 if mixed else 1


# --------------------------------------------------------------------------
# transcode: elementary-stream writers
# --------------------------------------------------------------------------

class _VideoFileWriter:
    """Write CodedMediaSamples to an elementary-stream file.

    Formats: ``avc``/``hevc`` -> Annex-B (parameter sets from the AVCC
    ``side["config"]`` re-emitted in-band), ``vp8``/``vp9`` -> IVF
    (header frame count back-patched on close), ``uncompressed`` -> Y4M.
    """

    def __init__(self, path: str, fmt):
        from .media.coded import MediaFormat

        self.path = path
        self.fmt = fmt
        self.fh = open(path, "wb")
        self.count = 0
        self._header_done = False
        self._pending = None     # first Y4M frame, held until fps is known
        self._mf = MediaFormat

    def _params_annexb(self, sample) -> bytes:
        from .codec import containers
        from .codec.ffmpeg_subprocess import sps_pps_from_avcdcr

        config = sample.side_data().get("config")
        if not config:
            return b""
        # a corrupt config record behaves like "no config yet": the header
        # stays unlatched and a later good SequenceStart can still size it
        try:
            if self.fmt == self._mf.hevc:
                params = containers.params_from_hvcc(config)
                return b"".join(b"\x00\x00\x00\x01" + nal
                                for nals in params.values() for nal in nals)
            sps_list, pps_list = sps_pps_from_avcdcr(config)
            return b"".join(b"\x00\x00\x00\x01" + nal
                            for nal in sps_list + pps_list)
        except ValueError:
            return b""

    def write(self, sample) -> bool:
        """Returns True when the sample will appear in the file; False
        when it was dropped (pre-header frames a decoder could never
        use) — callers count only accepted samples."""
        from .codec import bitstream, containers
        from .codec.codecs import unpack_uncompressed_picture
        from .codec.ffmpeg_subprocess import avcc_to_annexb
        from .media.coded import is_keyframe

        if self.fmt in (self._mf.avc, self._mf.hevc):
            if not self._header_done:
                params = self._params_annexb(sample)
                # only latch once parameter sets were actually written: a
                # sample without codec config (late E-RTMP SequenceStart,
                # receiver re-attach) must not leave the file permanently
                # headerless
                if params:
                    self.fh.write(params)
                    self._header_done = True
                elif self.count == 0 and not is_keyframe(sample):
                    # leading inter frames with no parameter sets are
                    # undecodable junk at the head of the file; a
                    # keyframe still goes through (it may carry in-band
                    # SPS/PPS) and a later SequenceStart can latch the
                    # header
                    return False
            self.fh.write(avcc_to_annexb(sample.data()))
        elif self.fmt in (self._mf.vp8, self._mf.vp9, self._mf.av1):
            if not self._header_done:
                codec = self.fmt.name
                try:
                    w, h = bitstream.IVF_FRAME_SIZE[codec](sample.data())
                except (ValueError, IndexError):
                    # joined mid-GOP: drop frames until the first
                    # keyframe sizes the IVF header (an interframe-led
                    # file would be undecodable anyway)
                    return False
                scale = max(sample.pts().scale, 1)
                self.fh.write(containers.ivf_header(
                    codec, w, h, timebase=(1, scale), n_frames=0))
                self._header_done = True
            self.fh.write(containers.ivf_frame(sample.data(),
                                               sample.pts().value))
        else:  # uncompressed -> Y4M
            pict = unpack_uncompressed_picture(
                sample.data(), asset_id=sample.asset_id(),
                workspace_id=sample.workspace_id())
            if not self._header_done:
                if self._pending is None:
                    # the Y4M header needs the frame RATE, which the
                    # timebase alone doesn't give — hold the first frame
                    # until the second's pts reveals the spacing
                    self._pending = (pict, sample.pts())
                    self.count += 1
                    return True       # held, written on close at latest
                self._write_y4m_header(self._pending[0],
                                       self._pending[1], sample.pts())
                self._write_y4m_frame(self._pending[0])
                self._pending = None
            self._write_y4m_frame(pict)
        self.count += 1
        return True

    def _write_y4m_header(self, pict, pts0, pts1=None) -> None:
        from .codec import containers
        from .core.time import rescale

        w, h = pict.size()
        fps = (30, 1)
        if pts1 is not None:
            dv = rescale(pts1, pts0.scale).value - pts0.value
            if dv > 0:
                fps = (max(pts0.scale, 1), dv)
        self.fh.write(containers.make_y4m_header(w, h, fps=fps))
        self._header_done = True

    def _write_y4m_frame(self, pict) -> None:
        import numpy as np

        self.fh.write(b"FRAME\n")
        for plane in pict.planes():
            self.fh.write(np.ascontiguousarray(
                np.asarray(plane)).tobytes())

    def close(self) -> None:
        if self._pending is not None:        # single-frame Y4M stream
            self._write_y4m_header(self._pending[0], self._pending[1])
            self._write_y4m_frame(self._pending[0])
            self._pending = None
        if self.fmt in (self._mf.vp8, self._mf.vp9, self._mf.av1) \
                and self._header_done:
            self.fh.seek(24)                 # IVF frame-count field
            self.fh.write(struct.pack("<I", self.count))
        self.fh.close()


class _AudioFileWriter:
    """ADTS (.aac/.adts) or Ogg-Opus (.opus) elementary-stream writer."""

    def __init__(self, path: str, fmt):
        from .media.coded import MediaFormat

        self.path = path
        self.fmt = fmt
        self.fh = open(path, "wb")
        self.count = 0
        self._ogg = None
        self._asc_bytes = object()   # sentinel: never equals a config
        self._asc_parsed = None
        self._mf = MediaFormat

    def write(self, sample) -> bool:
        from .codec import bitstream, containers
        from .codec.ffmpeg_subprocess import adts_header

        data = sample.data()
        if self.fmt == self._mf.aac:
            asc = sample.side_data().get("config")
            if asc != self._asc_bytes:
                # parse once per distinct config, not per sample (~46
                # ctypes parses/s/stream otherwise); a corrupt record is
                # treated as absent, like the video writer's configs — a
                # publisher's bad ASC must not kill the connection
                self._asc_bytes = asc
                try:
                    self._asc_parsed = (bitstream.aac_parse_asc(asc)
                                        if asc else None)
                except ValueError:
                    self._asc_parsed = None
            channels, rate, _spp = self._asc_parsed or (2, 48000, 1024)
            self.fh.write(adts_header(rate, channels, len(data)) + data)
        else:  # opus
            if self._ogg is None:
                head = sample.side_data().get("config")
                channels = (head[9] if head and len(head) > 9 else 2)
                self._ogg = containers.OggOpusWriter(channels, head=head)
                self.fh.write(self._ogg.header())
            self.fh.write(self._ogg.page(
                data, samples=containers.opus_packet_samples(data)))
        self.count += 1
        return True

    def close(self) -> None:
        self.fh.close()


class _ContainerFileWriter:
    """Mux video+audio CodedMediaSamples into a real container (mp4/flv/
    mkv/webm) via libavformat — one shared writer when --video-out and
    --audio-out name the same file.  Same ``write(sample) -> bool`` duck
    type as the elementary-stream writers.

    Stream declaration is lazy (geometry/rate parsed from the first
    sample's config record); packets arriving before every expected
    stream is declared are buffered, because the container header must
    list all streams up front."""

    def __init__(self, path: str, *, expect_video: bool, expect_audio: bool):
        from .codec.avformat import MediaFileWriter

        self.path = path
        self._mux = MediaFileWriter(path)
        self._expect = {"video": expect_video, "audio": expect_audio}
        self._idx = {}
        self._buffer = []
        self._started = False
        self.count = 0

    def _declare(self, sample, kind: str) -> bool:
        from .codec import bitstream, containers
        from .codec.ffmpeg_subprocess import sps_pps_from_avcdcr
        from .media.coded import MediaFormat

        config = sample.side_data().get("config", b"")
        try:
            if kind == "video":
                if sample.media_format == MediaFormat.avc:
                    sps_list, _ = sps_pps_from_avcdcr(config)
                    w, h = bitstream.h264_sps_frame_size(sps_list[0])
                elif sample.media_format == MediaFormat.hevc:
                    params = containers.params_from_hvcc(config)
                    w, h = bitstream.h265_sps_frame_size(params[33][0])
                elif sample.media_format == MediaFormat.vp9:
                    w, h = bitstream.vp9_frame_size(sample.data())
                elif sample.media_format == MediaFormat.av1:
                    w, h = bitstream.av1_frame_size(sample.data())
                else:
                    w, h = bitstream.vp8_frame_size(sample.data())
                self._idx[kind] = self._mux.add_video_stream(
                    sample.media_format, w, h, config)
            else:
                if sample.media_format == MediaFormat.aac:
                    channels, rate, _ = bitstream.aac_parse_asc(config)
                else:
                    head = (containers.parse_opus_head(config)
                            if config[:8] == b"OpusHead" else None)
                    channels = head["channels"] if head else 2
                    rate = 48000
                self._idx[kind] = self._mux.add_audio_stream(
                    sample.media_format, rate, channels, config)
            return True
        except (ValueError, KeyError, IndexError):
            return False     # no/corrupt config yet: try again later

    def write(self, sample) -> bool:
        from .media.coded import MediaType

        kind = ("video" if sample.media_type == MediaType.video
                else "audio")
        if not self._expect[kind]:
            return False
        if not self._started:
            if kind not in self._idx and not self._declare(sample, kind):
                # no usable config yet (e.g. inter frames before the
                # first keyframe header): buffer as promised — the
                # packets are written once the stream declares (or
                # dropped at close if it never does)
                self._buffer.append((kind, sample))
                return True
            if all(k in self._idx
                   for k, want in self._expect.items() if want):
                self._started = True
                self._mux.write_header()
                for pend_kind, pend in self._buffer:
                    self._mux.write(self._idx[pend_kind], pend)
                    self.count += 1
                self._buffer = []
            else:
                self._buffer.append((kind, sample))
                return True
        self._mux.write(self._idx[kind], sample)
        self.count += 1
        return True

    def close(self) -> None:
        if not self._started and self._idx:
            # EOF with an expected track that never arrived: write the
            # header with the streams that DID declare, drain their
            # buffered packets (an absent track must not void the file)
            self._started = True
            self._mux.write_header()
            for kind, pend in self._buffer:
                if kind in self._idx:
                    self._mux.write(self._idx[kind], pend)
                    self.count += 1
            self._buffer = []
        self._mux.close()


_VIDEO_EXT = {".h264": "avc", ".avc": "avc", ".264": "avc",
              ".h265": "hevc", ".hevc": "hevc", ".265": "hevc",
              ".ivf": "vp9", ".y4m": "uncompressed"}
_AUDIO_EXT = {".aac": "aac", ".adts": "aac", ".opus": "opus"}
# container outputs (muxed via libavformat): default codec per extension
_CONTAINER_VCODEC = {".mp4": "avc", ".mov": "avc", ".flv": "avc",
                     ".mkv": "avc", ".webm": "vp9"}
_CONTAINER_ACODEC = {".mp4": "aac", ".mov": "aac", ".flv": "aac",
                     ".mkv": "aac", ".webm": "opus"}


def _fmt_for(path: str, table, override: Optional[str]):
    from .media.coded import MediaFormat

    name = override or table.get(os.path.splitext(path)[1].lower())
    if name is None:
        raise SystemExit(f"cannot infer codec from {path!r}; pass --vcodec/"
                         f"--acodec (known: {sorted(set(table.values()))})")
    return MediaFormat[name]


def cmd_transcode(args: argparse.Namespace) -> int:
    """File -> decode -> (SRC) -> encode -> elementary stream files
    (Examples/Transcoding: rename >> decode >> encode graphs)."""
    _device_setup()
    import time

    from .codec.codecs import (AudioDecoder, AudioEncoder, VideoDecoder,
                               VideoEncoder, bitstream_backend)
    from .codec.file_source import open_media_file, open_media_file_av
    from .codec.transcode import asset_rename, flat
    from .core import EventBox, StepClock, TimePoint, Tx
    from .media.audio import AudioFormat
    from .mix.src_audio import AudioSampleRateConversion

    if not args.video_out and not args.audio_out:
        raise SystemExit("nothing to do: pass --video-out and/or --audio-out")

    clock = StepClock(TimePoint(10, 1000))
    vsrc = asrc = None
    if bitstream_backend() is not None:
        vsrc, asrc = open_media_file_av(clock, args.input, asset_id="in")
    else:
        vsrc = open_media_file(clock, args.input, asset_id="in")
        if args.audio_out:
            print("warning: no codec backend; cv2 path demuxes video only",
                  file=sys.stderr)

    chains = []
    writers = []
    counts = {"video": 0, "audio": 0}
    vdec = venc = adec = aenc = None

    # container outputs: --video-out and --audio-out may name the SAME
    # mp4/flv/mkv/webm file — one muxer receives both encoded tracks
    def _container_ext(path):
        ext = os.path.splitext(path or "")[1].lower()
        return ext if ext in _CONTAINER_VCODEC else None

    if any(_container_ext(p) for p in (args.video_out, args.audio_out)
           if p) and bitstream_backend() != "libav":
        raise SystemExit("container output needs the libav backend")
    shared_container = None
    if args.video_out and _container_ext(args.video_out):
        shared_container = _ContainerFileWriter(
            args.video_out, expect_video=True,
            expect_audio=(args.audio_out == args.video_out))
        writers.append(shared_container)

    if args.video_out and vsrc is not None:
        cext = _container_ext(args.video_out)
        if cext:
            vfmt = _fmt_for(args.video_out,
                            {cext: _CONTAINER_VCODEC[cext]}, args.vcodec)
            vw = shared_container
        else:
            vfmt = _fmt_for(args.video_out, _VIDEO_EXT, args.vcodec)
            vw = _VideoFileWriter(args.video_out, vfmt)
            writers.append(vw)
        vdec, venc = VideoDecoder(), VideoEncoder(vfmt)

        def wv(s, _w=vw):
            for one in (s if isinstance(s, list) else [s]):
                if _w.write(one):   # count only samples that reach the file
                    counts["video"] += 1
            return EventBox.just(s)

        wv_tx = Tx(wv)
        # explicit stages (vs make_video_transcoder) so the codec tails
        # can be flushed after the clock drains (Examples/Transcoding)
        chains.append(vsrc >> asset_rename("out") >> vdec >> flat(venc)
                      >> wv_tx)
    if args.audio_out and asrc is not None:
        aext = _container_ext(args.audio_out)
        if aext:
            afmt = _fmt_for(args.audio_out,
                            {aext: _CONTAINER_ACODEC[aext]}, args.acodec)
            if args.audio_out == args.video_out:
                aw = shared_container      # one muxed A+V file
            else:
                aw = _ContainerFileWriter(args.audio_out,
                                          expect_video=False,
                                          expect_audio=True)
                writers.append(aw)
        else:
            afmt = _fmt_for(args.audio_out, _AUDIO_EXT, args.acodec)
            aw = _AudioFileWriter(args.audio_out, afmt)
            writers.append(aw)
        adec, aenc = AudioDecoder(), AudioEncoder(afmt, 1024)
        src_stage = AudioSampleRateConversion(args.rate, 2, AudioFormat.s16i)

        def wa(s, _w=aw):
            for one in (s if isinstance(s, list) else [s]):
                if _w.write(one):
                    counts["audio"] += 1
            return EventBox.just(s)

        wa_tx = Tx(wa)
        chains.append(asrc >> asset_rename("out") >> adec >> flat(src_stage)
                      >> flat(aenc) >> wa_tx)

    for src in (vsrc, asrc):
        if src is not None:
            src.play()
    for i in range(args.max_ticks):
        clock.step()
        if i % 10 == 9:
            time.sleep(0.02)      # paced: let the codec subprocesses run
        if all(not getattr(s, "_playing", False)
               for s in (vsrc, asrc) if s is not None):
            # drain: the sources stopped pulling, but their read-ahead
            # (2 s of stream time) is still scheduled on the clock — step
            # until the schedule queue is empty, not a guessed tick count
            drained = 0
            while clock.pending_count() and drained < 4096:
                clock.step()
                drained += 1
                if drained % 32 == 31:
                    time.sleep(0.02)   # let codec subprocess replies land
            for _ in range(8):         # subprocess-backend reply tail
                clock.step()
                time.sleep(0.005)
            break
    # flush codec tails (encoder latency + AU-split holdback)
    if vdec is not None:
        for pic in vdec.flush():
            box = venc(pic)
            if box.is_just():
                v = box.value()
                # uncompressed encode returns a SINGLE sample; the live
                # chain normalizes via flat(), the tail path must too
                for s in (v if isinstance(v, list) else [v]):
                    wv_tx(s)
        for s in venc.flush():
            wv_tx(s)
        venc.close()
    if adec is not None:
        # tail PCM takes the same path as the live chain: decoder ->
        # sample-rate conversion -> encoder (a 44.1 kHz tail fed straight
        # into a 48 kHz-locked encoder pipe would be mispitched)
        def _encode_tail(a):
            box = aenc(a)
            if box.is_just():
                for s in box.value():
                    wa_tx(s)

        for a in adec.flush():
            b = src_stage(a)
            if b.is_just():
                _encode_tail(b.value())
        for a in src_stage.flush():
            _encode_tail(a)
        for s in aenc.flush():
            wa_tx(s)
        aenc.close()
    del chains
    for w in writers:
        w.close()
    print(f"transcoded: {counts['video']} video samples"
          f" -> {args.video_out or '-'}, {counts['audio']} audio samples"
          f" -> {args.audio_out or '-'}")
    return 0 if (counts["video"] or counts["audio"]) else 1


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

def cmd_serve(args: argparse.Namespace) -> int:
    """RTMP ingest server (Examples/RtmpServer): accept every publisher,
    count media; --record writes Annex-B/ADTS per published stream.
    --workers N forks N-1 children, every process serving the SAME port
    with SO_REUSEPORT (the kernel shards connections across them) — the
    scale-out shape for the single-core ingest ceiling, standing in for
    the reference's SwiftNIO threaded EventLoopGroup."""
    import asyncio

    from .core import EventBox, Tx, WallClock
    from .media.coded import MediaFormat, MediaType

    workers = max(1, int(getattr(args, "workers", 1) or 1))
    reuse_port = workers > 1
    children: List[int] = []
    if reuse_port:
        for _ in range(workers - 1):
            pid = os.fork()
            if pid == 0:
                children = []   # child: serve like the parent
                break
            children.append(pid)

    async def run() -> int:
        from .net.rtmp import Rtmp

        stats = {}
        writers = {}
        chains = []

        def on_sample(path, s):
            st = stats.setdefault(path, {"video": 0, "audio": 0, "bytes": 0})
            key = ("video" if s.media_type == MediaType.video else "audio")
            st[key] += 1
            st["bytes"] += len(s.data())
            if args.record:
                wkey = (path, key)
                if wkey not in writers:
                    os.makedirs(args.record, exist_ok=True)
                    safe = path.strip("/").replace("/", "_") or "stream"
                    if key == "video":
                        # _VideoFileWriter emits Annex-B for avc/hevc and
                        # IVF for vp8/vp9 — the extension must match
                        ext = {MediaFormat.avc: ".h264",
                               MediaFormat.hevc: ".h265"}.get(
                                   s.media_format, ".ivf")
                        writers[wkey] = _VideoFileWriter(
                            os.path.join(args.record, safe + ext),
                            s.media_format)
                    else:
                        ext = ".adts" if s.media_format == MediaFormat.aac \
                            else ".opus"
                        writers[wkey] = _AudioFileWriter(
                            os.path.join(args.record, safe + ext),
                            s.media_format)
                writers[wkey].write(s)
            return EventBox.nothing(None)

        async def on_connection(pub, sub):
            if sub is not None:
                # Key by the app-qualified path: a bare play_path collides
                # across apps (/a/cam0 and /b/cam0 would overwrite each
                # other's recording and share a stats bucket).
                app = sub.workspace_id()
                path = f"{app}/{sub.play_path()}" if app else sub.play_path()
                print(f"publisher: {path}", flush=True)
                chains.append(sub >> Tx(lambda s, p=path: on_sample(p, s)))
            return True

        clock = WallClock()
        server = Rtmp(clock, on_connection=on_connection,
                      on_ended=lambda a: print("ended:", a, flush=True))
        await server.serve(args.host, args.port, reuse_port=reuse_port)
        # single atomic os.write: with --workers N every process shares
        # this stdout pipe, and print() can split message/newline into two
        # writes that interleave across workers, corrupting the announce
        # lines consumers (tests, orchestration) parse
        sys.stdout.flush()
        os.write(sys.stdout.fileno(),
                 (f"rtmp://{args.host}:{args.port}/ "
                  f"(pid {os.getpid()}, ctrl-c to stop)\n").encode())
        try:
            if args.max_seconds:
                await asyncio.sleep(args.max_seconds)
            else:
                while True:
                    await asyncio.sleep(3600)
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
        finally:
            # stop the server FIRST: closing writers while connections
            # still drain would hand closed file handles to on_sample
            await server.close()
            for w in writers.values():
                w.close()
        for path, st in stats.items():
            print(f"{path}: {st['video']} video / {st['audio']} audio "
                  f"samples, {st['bytes']} bytes")
        return 0

    try:
        rc = asyncio.run(run())
    except KeyboardInterrupt:
        rc = 0
    for pid in children:           # parent: reap worker children
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    return rc


# --------------------------------------------------------------------------
# probe
# --------------------------------------------------------------------------

def cmd_probe(args: argparse.Namespace) -> int:
    """Print stream parameters of an elementary/container file as JSON —
    exercises the container/bitstream parsers (sample.coded.swift's
    basicMediaDescription analogue at file level)."""
    from .codec import bitstream, containers
    from .codec.ffmpeg_subprocess import parse_adts_frames, split_annexb

    with open(args.input, "rb") as fh:
        data = fh.read()
    info = {"path": args.input, "bytes": len(data)}
    if data[:4] == b"DKIF":
        header, frames, _rest = containers.parse_ivf(data)
        if header:
            header = dict(header, codec=header["codec"].decode("ascii",
                                                               "replace"))
        info.update(container="ivf", **(header or {}), frames=len(frames))
    elif data[:9] == b"YUV4MPEG2":
        reader = containers.Y4MReader()
        reader.feed(data[:4096])
        info.update(container="y4m", width=reader.width,
                    height=reader.height, fps=reader.fps)
    elif data[:4] == b"OggS":
        reader = containers.OggPacketReader()
        reader.feed(data)
        packets = reader.packets()
        info.update(container="ogg", packets=len(packets))
        if packets and packets[0][0][:8] == b"OpusHead":
            info.update(codec="opus",
                        **containers.parse_opus_head(packets[0][0]))
    elif len(data) > 2 and data[0] == 0xFF and (data[1] & 0xF0) == 0xF0:
        frames, _carry = parse_adts_frames(data)
        rate_tab = bitstream.AAC_SAMPLE_RATES
        idx = (data[2] >> 2) & 0xF
        info.update(container="adts", codec="aac", frames=len(frames),
                    sample_rate=rate_tab[idx] if idx < len(rate_tab) else 0,
                    channels=((data[2] & 1) << 2) | (data[3] >> 6))
    elif data[:5].startswith(b"\x00\x00\x00\x01") or \
            data[:4].startswith(b"\x00\x00\x01"):
        nals = split_annexb(data)
        info.update(container="annexb", nal_units=len(nals))
        for nal in nals:
            if nal and (nal[0] & 0x1F) == 7:          # H.264 SPS
                try:
                    w, h = bitstream.h264_sps_frame_size(nal)
                except Exception:  # noqa: BLE001 — truncated/foreign SPS
                    info.update(codec="avc")
                else:
                    info.update(codec="avc", width=w, height=h)
                break
    elif data[:7].startswith(b"MOCKAV "):
        head = data.split(b"\n", 1)[0].decode().split()
        info.update(container="mockav", width=int(head[1]),
                    height=int(head[2]),
                    fps=(int(head[3]), int(head[4])), frames=int(head[5]),
                    sample_rate=int(head[6]), channels=int(head[7]),
                    audio_samples=int(head[8]))
    else:
        info["container"] = "unknown"
    print(json.dumps(info))
    return 0 if info.get("container") != "unknown" else 1


# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m swiftvideo_tpu",
        description="SwiftVideo command line (mix / transcode / serve /"
                    " probe)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("mix", help="composite a composition JSON to PNGs")
    p.add_argument("composition", nargs="?",
                   help="composition manifest JSON (default: demo scene)")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--every", type=int, default=10,
                   help="write every Nth frame (default 10)")
    p.add_argument("--out", default="/tmp/svtpu_mix")
    p.add_argument("--workspace", default="cli")
    p.set_defaults(fn=cmd_mix)

    p = sub.add_parser("transcode",
                       help="transcode a media file to elementary streams")
    p.add_argument("input")
    p.add_argument("--video-out", help=".h264/.h265/.ivf/.y4m output path")
    p.add_argument("--audio-out", help=".aac/.adts/.opus output path")
    p.add_argument("--vcodec", choices=["avc", "hevc", "vp8", "vp9",
                                        "av1", "uncompressed"])
    p.add_argument("--acodec", choices=["aac", "opus"])
    p.add_argument("--rate", type=int, default=48000,
                   help="audio output sample rate")
    p.add_argument("--max-ticks", type=int, default=100_000)
    p.set_defaults(fn=cmd_transcode)

    p = sub.add_parser("serve", help="RTMP ingest server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=1935)
    p.add_argument("--record", help="directory to record published streams")
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="stop after N seconds (0 = run forever)")
    p.add_argument("--workers", type=int, default=1,
                   help="SO_REUSEPORT worker processes sharing the port "
                        "(one asyncio loop saturates a core at ~110x "
                        "realtime aggregate ingest; run one worker per "
                        "core to scale out)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("probe", help="print stream parameters as JSON")
    p.add_argument("input")
    p.set_defaults(fn=cmd_probe)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
