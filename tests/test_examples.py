"""Smoke-run every demo in examples/ as a subprocess.

The reference ships its examples as built executables
(/root/reference/Examples/{Mixing,RtmpServer,Transcoding}/main.swift) that
CI compiles; the analogue here is actually EXECUTING each demo script so
the shipped entry points stay runnable, not just importable.  Each demo is
self-contained (synthetic sources, loopback sockets, mock ffmpeg) and
prints a deterministic success marker.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
MOCK_FFMPEG = os.path.join(REPO, "tests", "mock_ffmpeg.py")


def _demo_env():
    env = dict(os.environ)
    # CPU-only: SV_DEVICE=cpu pins the demos that honour it, and
    # JAX_PLATFORMS=cpu keeps every other demo off a visible accelerator
    env["JAX_PLATFORMS"] = "cpu"
    env["SV_DEVICE"] = "cpu"
    env["SWIFTVIDEO_FFMPEG"] = MOCK_FFMPEG
    return env


def _run(name, *argv, timeout=240):
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, name), *argv],
        env=_demo_env(), cwd=REPO, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}\n--- stdout\n{proc.stdout}"
        f"\n--- stderr\n{proc.stderr}")
    return proc.stdout


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mixing_demo(tmp_path):
    out = _run("mixing_demo.py", str(tmp_path))
    assert "wrote" in out and "frame.png" in out
    assert (tmp_path / "frame.png").exists()


def test_multiview_demo(tmp_path):
    out = _run("multiview_demo.py", str(tmp_path))
    # png dump is optional in this demo; the mix itself must report
    assert "wall" in out or "wrote" in out


def test_rotation_demo(tmp_path):
    out = _run("rotation_demo.py", str(tmp_path))
    assert "wrote" in out


def test_transcoding_demo():
    out = _run("transcoding_demo.py")
    assert "transcoded" in out
    n = int(out.split("transcoded", 1)[1].split()[0])
    assert n >= 25


def test_motion_demo():
    out = _run("motion_demo.py")
    assert "motion demo OK" in out


def test_real_codec_demo():
    from swiftvideo_tpu.codec.libav import libav_available
    if not libav_available():
        pytest.skip("libav shim not available")
    out = _run("real_codec_demo.py")
    assert "authored" in out and "H.264" in out
    assert "tone recovered" in out


def test_proto_interop_demo():
    out = _run("proto_interop_demo.py")
    assert "proto interop demo OK" in out


def test_rtmp_server_demo():
    # _free_port() closes the probe socket before the demo re-binds it
    # (inherent TOCTOU); retry once with a fresh port if the bind lost
    # the race to a concurrent process
    for attempt in range(2):
        try:
            out = _run("rtmp_server_demo.py", str(_free_port()))
            break
        except AssertionError as exc:
            if attempt == 0 and "Address already in use" in str(exc):
                continue
            raise
    assert "publisher connected" in out
    n = int(out.rsplit("server received", 1)[1].split()[0])
    assert n >= 25


def test_wall_demo():
    out = _run("wall_demo.py", "8")
    assert "wrote" in out or "tick" in out.lower()


@pytest.mark.slow
def test_live_station_demo():
    out = _run("live_station_demo.py", timeout=360)
    assert "[station] ok" in out


def test_live_station_demo_real_codecs():
    """The FULL production topology (2 RTMP cams -> decode -> Composer
    -> encode -> RTMP program out) on REAL codecs: with no
    SWIFTVIDEO_FFMPEG override, dispatch routes avc/aac through the
    in-process libav backend end to end."""
    from swiftvideo_tpu.codec.libav import libav_available
    if not libav_available():
        pytest.skip("libav shim not available")
    env = _demo_env()
    env.pop("SWIFTVIDEO_FFMPEG", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "live_station_demo.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "[station] ok" in proc.stdout
    assert "mixed video frames" in proc.stdout
