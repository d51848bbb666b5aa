#!/usr/bin/env -S python3 -S -E
"""Mock ffmpeg: speaks the exact pipe contract ``ffmpeg_subprocess.py``
generates, so the Popen/reader-thread/flush plumbing runs end-to-end in CI
without a real ffmpeg binary (VERDICT r2 item #2).

Supported invocations (the only ones the backend generates):

* ``-f h264|hevc -i pipe:0 -f yuv4mpegpipe -pix_fmt yuv420p pipe:1``
* ``-f ivf -i pipe:0 -f yuv4mpegpipe -pix_fmt yuv420p pipe:1``
* ``-f rawvideo -pix_fmt yuv420p -s WxH -r N -i pipe:0 -c:v libx264|libx265
  ... -f h264|hevc pipe:1`` (and ``-c:v libvpx|libvpx-vp9 ... -f ivf``)
* ``-f aac -i pipe:0 -f s16le -ar R -ac C pipe:1``
* ``-f ogg -i pipe:0 -f s16le -ar 48000 -ac C pipe:1``
* ``-f s16le -ar R -ac C -i pipe:0 -c:a aac -f adts pipe:1``
  (and ``-c:a libopus -f ogg``)

The "codec" is stored-raw: a video access unit's slice NAL carries
``u16 w, u16 h`` + the yuv420p planes (emulation-prevention-escaped for
Annex B, with a 0x80 stop byte so no NAL ends in zero); audio packets carry
raw s16 PCM (1024 samples per AAC frame, 960 per Opus packet).  Container
framing (Annex B + AUD/SPS/PPS structure, IVF, Y4M, ADTS, Ogg) matches what
real ffmpeg emits, so the Python side's splitting/config logic is exercised
for real.  The video encoder buffers ONE access unit before emitting
(simulating encoder latency) so the pts ring and ``flush()`` recovery paths
run; the audio encoder accumulates to exact frame sizes and pads the final
frame at EOF, like libfdk/libopus.
"""

import importlib.util
import os
import re
import struct
import sys

# load containers.py directly by path: importing the swiftvideo_tpu package
# costs ~2 s (numpy etc.), which starves the paced-ingest pipe tests
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "_mock_containers",
    os.path.join(_REPO, "swiftvideo_tpu", "codec", "containers.py"))
containers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(containers)

# ADTS helpers inlined for the same reason (independent of the library's —
# which doubles as a cross-check in the roundtrip tests)
_ADTS_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
               16000, 12000, 11025, 8000, 7350]


def adts_header(sample_rate, channels, payload_len, profile=1):
    idx = _ADTS_RATES.index(sample_rate)
    length = payload_len + 7
    return bytes([
        0xFF, 0xF1,
        ((profile & 3) << 6) | ((idx & 0xF) << 2) | ((channels >> 2) & 1),
        ((channels & 3) << 6) | ((length >> 11) & 3),
        (length >> 3) & 0xFF,
        ((length & 7) << 5) | 0x1F,
        0xFC,
    ])


def adts_payload(frame):
    return frame[7 if frame[1] & 1 else 9:]


def parse_adts_frames(data):
    frames, pos = [], 0
    while pos + 7 <= len(data):
        if data[pos] != 0xFF or (data[pos + 1] & 0xF0) != 0xF0:
            pos += 1
            continue
        length = ((data[pos + 3] & 0x03) << 11) | (data[pos + 4] << 3) | \
            (data[pos + 5] >> 5)
        if length < 7 or pos + length > len(data):
            break
        frames.append(data[pos:pos + length])
        pos += length
    return frames, data[pos:]

STDIN = sys.stdin.buffer
STDOUT = sys.stdout.buffer


class _JitterPipe:
    """Re-chunk stdout into odd-sized bursts with held-back tails and
    micro-stalls, and throttle stdin reads — simulating a real ffmpeg's
    stdio buffering and rate behaviour (a slow encoder draining stdout in
    bursts that never align with frame boundaries, and consuming stdin
    slower than the producer writes, so the 64 KiB pipe buffer exerts
    backpressure).  Enabled by ``MOCK_FFMPEG_JITTER=<seed>`` in the
    environment; deterministic per seed.  Mirrors the buffering surprises
    of ``enc.video.ffmpeg.swift:92-130``'s real libav contact that CI
    cannot otherwise reach (VERDICT r3 item #7).
    """

    SIZES = (1, 3, 7, 17, 61, 257, 1021, 4093, 16381)

    def __init__(self, seed: int):
        import random
        self.rng = random.Random(seed)
        self.pend = bytearray()

    def write(self, data: bytes) -> None:
        import time
        self.pend += data
        while self.pend:
            if self.rng.random() < 0.3:
                break            # hold a tail until the next emit/drain
            n = self.rng.choice(self.SIZES)
            chunk = bytes(self.pend[:n])
            del self.pend[:n]
            STDOUT.write(chunk)
            STDOUT.flush()
            if self.rng.random() < 0.2:
                time.sleep(self.rng.random() * 0.003)

    def drain(self) -> None:
        if self.pend:
            STDOUT.write(bytes(self.pend))
            STDOUT.flush()
            self.pend.clear()

    def read_size(self) -> int:
        import time
        if self.rng.random() < 0.2:
            time.sleep(self.rng.random() * 0.002)
        return self.rng.choice((509, 4093, 65536))


_jseed = os.environ.get("MOCK_FFMPEG_JITTER")
JITTER = _JitterPipe(int(_jseed)) if _jseed else None


# emulation prevention: an 0x03 after every two zeros that precede a
# byte <= 3 (regex scans in C: 1080p frames are megabytes)
_EPB_ESCAPE = re.compile(b"\x00\x00(?=[\x00-\x03])")
_EPB_UNESCAPE = re.compile(b"\x00\x00\x03(?=[\x00-\x03])")


def epb_escape(data: bytes) -> bytes:
    return _EPB_ESCAPE.sub(b"\x00\x00\x03", data)


def epb_unescape(data: bytes) -> bytes:
    return _EPB_UNESCAPE.sub(b"\x00\x00", data)


def parse_args(argv):
    """Split ``[global] [in-opts] -i <input> [out-opts] pipe:1`` into
    (in_opts, out_opts, input) — input is ``pipe:0`` or a file path."""
    pre, post = [], []
    it = iter(argv)
    seen_i = False
    src = "pipe:0"
    for tok in it:
        if tok in ("-hide_banner",):
            continue
        if tok == "-loglevel":
            next(it)
            continue
        if tok == "-i":
            src = next(it)
            seen_i = True
            continue
        (post if seen_i else pre).append(tok)
    assert post and post[-1] == "pipe:1", post
    post = post[:-1]

    def to_opts(toks):
        opts = {}
        i = 0
        while i < len(toks):
            if toks[i].startswith("-"):
                if i + 1 < len(toks) and not toks[i + 1].startswith("-"):
                    opts[toks[i]] = toks[i + 1]
                    i += 2
                else:
                    opts[toks[i]] = True
                    i += 1
            else:
                i += 1
        return opts

    return to_opts(pre), to_opts(post), src


def emit(data: bytes) -> None:
    if JITTER is not None:
        JITTER.write(data)
        return
    STDOUT.write(data)
    STDOUT.flush()


def read_loop(feed, eof):
    while True:
        n = JITTER.read_size() if JITTER is not None else 65536
        chunk = STDIN.read1(n) if hasattr(STDIN, "read1") \
            else os.read(0, n)
        if not chunk:
            break
        feed(chunk)
    eof()
    if JITTER is not None:
        JITTER.drain()


# --- video: mock bitstream <-> frames --------------------------------------

def nal_type(nal: bytes, hevc: bool) -> int:
    return ((nal[0] >> 1) & 0x3F) if hevc else (nal[0] & 0x1F)


def frame_payload(w, h, planes: bytes) -> bytes:
    return struct.pack(">HH", w, h) + planes


def vp8_key_prefix(w, h) -> bytes:
    """Real VP8 keyframe header (RFC 6386 §9.1) so the Python side's
    ``bitstream.vp8_frame_size`` parses mock packets."""
    return b"\x10\x00\x00\x9d\x01\x2a" + struct.pack("<HH", w, h)


def vp9_key_prefix(w, h) -> bytes:
    """Real VP9 keyframe uncompressed header (profile 0) for
    ``bitstream.vp9_frame_size``."""
    bits = "0000" + format(w - 1, "016b") + format(h - 1, "016b")
    bits += "0" * (-len(bits) % 8)
    body = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return bytes([0x82, 0x49, 0x83, 0x42]) + body


def av1_key_prefix(w, h) -> bytes:
    """Minimal real AV1 sequence-header OBU (reduced_still_picture_header)
    so ``bitstream.av1_frame_size`` parses mock packets."""
    bits = "000" + "0" + "1" + "00000" + format(15, "04b") + format(15, "04b")
    bits += format(w - 1, "016b") + format(h - 1, "016b")
    bits += "0" * (-len(bits) % 8)
    payload = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return bytes([0x0A, len(payload)]) + payload


def ivf_payload_planes(payload: bytes):
    """(w, h, planes) from a mock VP8/VP9/AV1 IVF payload."""
    if payload[0] == 0x0A:                                  # av1 seq OBU
        size = payload[1]
        bits = "".join(format(b, "08b") for b in payload[2:2 + size])
        return (int(bits[18:34], 2) + 1, int(bits[34:50], 2) + 1,
                payload[2 + size:])
    if payload[3:6] == b"\x9d\x01\x2a":                     # vp8
        w, h = struct.unpack_from("<HH", payload, 6)
        return w & 0x3FFF, h & 0x3FFF, payload[10:]
    assert payload[1:4] == b"\x49\x83\x42", "bad mock vp9"  # vp9
    bits = "".join(format(b, "08b") for b in payload[4:9])
    return int(bits[4:20], 2) + 1, int(bits[20:36], 2) + 1, payload[9:]


class AnnexbDecoder:
    """-f h264|hevc -> yuv4mpegpipe"""

    def __init__(self, hevc: bool):
        self.hevc = hevc
        self.carry = b""
        self.header_sent = False

    def _slices(self, data: bytes):
        slice_types = (1, 19, 20, 21) if self.hevc else (1, 2, 5)
        skip = 2 if self.hevc else 1
        for nal in iter_complete_nals(data):
            if nal and nal_type(nal, self.hevc) in slice_types:
                yield epb_unescape(nal[skip:])[:-1]  # drop stop byte

    def feed(self, chunk: bytes) -> None:
        self.carry += chunk
        # keep the (possibly incomplete) tail NAL: everything after the
        # final start code stays buffered; a sentinel start code
        # terminates the complete NALs before it
        last = max(self.carry.rfind(b"\x00\x00\x01"), 0)
        done, self.carry = self.carry[:last], self.carry[last:]
        if done:
            self._emit_frames(self._slices(done + b"\x00\x00\x01"))

    def _emit_frames(self, payloads) -> None:
        for payload in payloads:
            w, h = struct.unpack_from(">HH", payload)
            if not self.header_sent:
                emit(containers.make_y4m_header(w, h))
                self.header_sent = True
            emit(b"FRAME\n" + payload[4:4 + w * h * 3 // 2])

    def eof(self) -> None:
        self._emit_frames(self._slices(self.carry + b"\x00\x00\x01"))


def iter_complete_nals(data: bytes):
    """All NALs in ``data`` (terminated by a trailing start code)."""
    start = None
    i = data.find(b"\x00\x00\x01")
    while i != -1:
        if start is not None:
            end = i
            if end > start and data[end - 1] == 0:
                end -= 1
            yield data[start:end]
        start = i + 3
        i = data.find(b"\x00\x00\x01", start)


class IvfDecoder:
    """-f ivf -> yuv4mpegpipe"""

    def __init__(self):
        self.carry = b""
        self.header_sent = False

    def feed(self, chunk: bytes) -> None:
        self.carry += chunk
        _hdr, frames, self.carry = containers.parse_ivf(self.carry)
        for _pts, payload in frames:
            w, h, planes = ivf_payload_planes(payload)
            if not self.header_sent:
                emit(containers.make_y4m_header(w, h))
                self.header_sent = True
            emit(b"FRAME\n" + planes[:w * h * 3 // 2])

    def eof(self) -> None:
        self.feed(b"")


class RawvideoEncoder:
    """-f rawvideo -> mock h264/hevc Annex B or IVF, 1-AU latency."""

    def __init__(self, w, h, out_fmt, keyint, vp_codec="vp8"):
        self.w, self.h = w, h
        self.fsize = w * h * 3 // 2
        self.fmt = out_fmt            # h264 | hevc | ivf
        self.vp_codec = vp_codec
        self.keyint = max(1, keyint)
        self.carry = b""
        self.count = 0
        self.pending = None           # 1-frame encoder delay
        self.header_out = False

    def _au(self, planes: bytes, key: bool) -> bytes:
        hevc = self.fmt == "hevc"
        payload = epb_escape(frame_payload(self.w, self.h, planes)) + b"\x80"
        if hevc:
            aud = b"\x46\x01\x50"
            params = [b"\x40\x01\x0c", b"\x42\x01\x01\x21", b"\x44\x01\xc0"]
            slice_hdr = b"\x26\x01" if key else b"\x02\x01"
        else:
            aud = b"\x09\xf0"
            params = [b"\x67\x42\xc0\x1e\x80", b"\x68\xce\x38\x80"]
            slice_hdr = b"\x65" if key else b"\x41"
        nals = [aud] + (params if key else []) + [slice_hdr + payload]
        return b"".join(b"\x00\x00\x00\x01" + n for n in nals)

    def _ivf_frame(self, planes: bytes) -> bytes:
        out = b""
        if not self.header_out:
            out += containers.ivf_header(self.vp_codec, self.w, self.h)
            self.header_out = True
        prefix = {"vp8": vp8_key_prefix, "vp9": vp9_key_prefix,
                  "av1": av1_key_prefix}[self.vp_codec](self.w, self.h)
        return out + containers.ivf_frame(prefix + planes, self.count)

    def feed(self, chunk: bytes) -> None:
        self.carry += chunk
        while len(self.carry) >= self.fsize:
            planes, self.carry = (self.carry[:self.fsize],
                                  self.carry[self.fsize:])
            key = self.count % self.keyint == 0
            if self.fmt == "ivf":
                unit = self._ivf_frame(planes)
            else:
                unit = self._au(planes, key)
            self.count += 1
            if self.pending is not None:
                emit(self.pending)
            self.pending = unit

    def eof(self) -> None:
        if self.pending is not None:
            emit(self.pending)
            self.pending = None


# --- audio -----------------------------------------------------------------

class AdtsDecoder:
    """-f aac -> s16le (payload is stored PCM)."""

    def __init__(self):
        self.carry = b""

    def feed(self, chunk: bytes) -> None:
        self.carry += chunk
        frames, self.carry = parse_adts_frames(self.carry)
        for frame in frames:
            emit(adts_payload(frame))

    def eof(self) -> None:
        self.feed(b"")


class OggDecoder:
    """-f ogg -> s16le (packets are stored PCM)."""

    def __init__(self):
        self.reader = containers.OggPacketReader()

    def feed(self, chunk: bytes) -> None:
        self.reader.feed(chunk)
        for packet, _granule in self.reader.packets():
            if packet[:8] in (b"OpusHead", b"OpusTags"):
                continue
            emit(packet)

    def eof(self) -> None:
        self.feed(b"")


class PcmEncoder:
    """-f s16le -> ADTS ('aac') or Ogg ('opus'), stored-PCM payloads."""

    def __init__(self, rate, channels, kind):
        self.rate, self.channels, self.kind = rate, channels, kind
        self.spf = 1024 if kind == "aac" else 960
        self.fbytes = self.spf * channels * 2
        self.carry = b""
        self.ogg = (containers.OggOpusWriter(channels)
                    if kind == "opus" else None)
        self.header_out = False
        # real ffmpeg's ogg muxer batches several opus packets per page
        # (one granule covering all of them); mirror that so pipe
        # consumers must divide page-granule deltas across packets
        self.opus_pend = []
        self.opus_per_page = 3

    def _frame(self, payload: bytes) -> bytes:
        return adts_header(self.rate, self.channels,
                           len(payload)) + payload

    def _opus_page(self, eos: bool = False) -> bytes:
        out = b""
        if not self.header_out:
            out += self.ogg.header()
            self.header_out = True
        out += self.ogg.page_packets(self.opus_pend, samples_each=self.spf,
                                     eos=eos)
        self.opus_pend = []
        return out

    def feed(self, chunk: bytes) -> None:
        self.carry += chunk
        while len(self.carry) >= self.fbytes:
            payload, self.carry = (self.carry[:self.fbytes],
                                   self.carry[self.fbytes:])
            if self.kind == "aac":
                emit(self._frame(payload))
            else:
                self.opus_pend.append(payload)
                if len(self.opus_pend) >= self.opus_per_page:
                    emit(self._opus_page())

    def eof(self) -> None:
        if self.carry:
            payload = self.carry + b"\x00" * (self.fbytes - len(self.carry))
            self.carry = b""
            if self.kind == "aac":
                emit(self._frame(payload))
            else:
                self.opus_pend.append(payload)
        if self.kind == "opus" and self.opus_pend:
            emit(self._opus_page(eos=True))


def demux_file(path, post) -> int:
    """Demux a .mockav container file (the FileSource open_media_file_av
    pipe contract: ``-i <path> -an -f yuv4mpegpipe`` for video,
    ``-i <path> -vn -f s16le`` for audio).

    .mockav layout: ``MOCKAV w h fps_num fps_den n_frames rate channels
    n_samples\\n`` + n_frames raw yuv420p frames + n_samples interleaved
    s16 frames of audio.
    """
    with open(path, "rb") as fh:
        header = bytearray()
        while not header.endswith(b"\n"):
            header += fh.read(1)
        parts = header.split()
        assert parts[0] == b"MOCKAV", parts
        w, h, num, den, n_frames, rate, channels, n_samples = (
            int(v) for v in parts[1:9])
        fsize = w * h * 3 // 2
        video_bytes = fh.read(n_frames * fsize)
        audio_bytes = fh.read(n_samples * channels * 2)
    if "-an" in post:
        assert post.get("-f") == "yuv4mpegpipe", post
        emit(containers.make_y4m_header(w, h, fps=(num, den)))
        for i in range(n_frames):
            emit(b"FRAME\n" + video_bytes[i * fsize:(i + 1) * fsize])
        return 0
    if "-vn" in post:
        assert post.get("-f") == "s16le", post
        # stored rate/channels must match the request (no resampling in
        # the mock); emit in 64 KiB chunks like a real pipe
        assert int(post["-ar"]) == rate and int(post["-ac"]) == channels, \
            (post, rate, channels)
        for i in range(0, len(audio_bytes), 65536):
            emit(audio_bytes[i:i + 65536])
        return 0
    sys.stderr.write("mock_ffmpeg: file demux needs -an or -vn\n")
    return 2


def main() -> int:
    pre, post, src = parse_args(sys.argv[1:])
    in_fmt = pre.get("-f")
    out_fmt = post.get("-f")
    if src != "pipe:0":
        rc = demux_file(src, post)
        if JITTER is not None:
            JITTER.drain()
        return rc
    if in_fmt in ("h264", "hevc"):
        assert out_fmt == "yuv4mpegpipe", post
        worker = AnnexbDecoder(hevc=in_fmt == "hevc")
    elif in_fmt == "ivf":
        worker = IvfDecoder()
    elif in_fmt == "rawvideo":
        w, h = (int(v) for v in pre["-s"].split("x"))
        keyint = 30
        for params_key in ("-x264-params", "-x265-params"):
            if params_key in post:
                for kv in post[params_key].split(":"):
                    if kv.startswith("keyint="):
                        keyint = int(kv.split("=")[1])
        if "-g" in post:
            keyint = int(post["-g"])
        vp_codec = {"libvpx-vp9": "vp9",
                    "libaom-av1": "av1"}.get(post.get("-c:v"), "vp8")
        worker = RawvideoEncoder(w, h, out_fmt, keyint, vp_codec)
    elif in_fmt == "aac":
        worker = AdtsDecoder()
    elif in_fmt == "ogg":
        worker = OggDecoder()
    elif in_fmt == "s16le":
        kind = "aac" if post.get("-c:a") == "aac" else "opus"
        worker = PcmEncoder(int(pre["-ar"]), int(pre["-ac"]), kind)
    else:
        sys.stderr.write(f"mock_ffmpeg: unsupported args {sys.argv[1:]}\n")
        return 2
    read_loop(worker.feed, worker.eof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
