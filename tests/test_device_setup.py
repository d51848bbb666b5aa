"""The one device path: compile cache placement, the compute registry
without a Pallas backend, the stats timer read-out, the driver entry, and
the ingest server staying off the device."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_env(monkeypatch):
    import jax

    from swiftvideo_tpu.utils import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []


def test_compile_cache_defaults_into_checkout(monkeypatch):
    import jax

    from swiftvideo_tpu.utils import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_registry_has_no_pallas_backend():
    from swiftvideo_tpu.ops.registry import ComputeError, make_compute_context
    assert make_compute_context().backend == "jax"
    assert make_compute_context("golden").device is None
    with pytest.raises(ComputeError):
        make_compute_context("pallas")


def test_audio_mixer_device_gate_is_jax_only():
    from swiftvideo_tpu.core import StepClock, TimePoint
    from swiftvideo_tpu.mix.audio_mixer import AudioMixer
    from swiftvideo_tpu.ops.registry import ComputeContext
    mixer = AudioMixer(StepClock(TimePoint(480, 48000)), workspace_id="w",
                       frame_duration=TimePoint(480, 48000),
                       sample_rate=48000, channel_count=2,
                       compute_context=ComputeContext(backend="pallas"))
    backing = np.zeros(960, np.int16)
    data = np.full(960, 100, np.int16)
    mixer.device_min_elems = 0
    mixer._run_mix([(data, (1.0, 1.0), 0, 0)], backing)  # host fold
    assert np.all(backing == 100)


def test_stats_sample_values_reads_timers():
    from swiftvideo_tpu.core import StatsReport, StepClock, TimePoint
    clock = StepClock(TimePoint(10, 1000))
    rep = StatsReport(clock=clock)
    rep.start_timer("t")
    clock.step()
    rep.end_timer("t")
    rep.add_sample("n", 3)
    assert rep.sample_values("t") == [0.01]
    assert rep.sample_values("n") == [3.0]
    assert rep.sample_values("missing") == []


def test_entry_is_the_mixer_tick_program():
    """entry()'s step runs the program VideoMixer runs for its scene
    (composite.composite_tick): bit-identical output."""
    import jax

    import __graft_entry__ as ge
    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import composite
    from swiftvideo_tpu.ops.uniforms import UNIFORM_WIDTH
    step, args = ge.entry()
    out = jax.jit(step)(*args)
    ys, us, vs, unis = args[:4]
    assert unis.shape == (4, UNIFORM_WIDTH)
    srcs = [([ys[i], us[i], vs[i]], PixelFormat.y420p, np.asarray(unis[i]))
            for i in range(4)]
    tick = composite.composite_tick(PixelFormat.y420p, (1920, 1080), srcs)
    for o, t in zip(out[:3], tick):
        assert np.array_equal(np.asarray(o), np.asarray(t))
    assert out[3].shape == (1920,)


def test_serve_path_never_imports_jax():
    """`serve --workers N` forks after these imports: no child may hold
    (or start) the device backend."""
    code = ("import sys, swiftvideo_tpu.cli, swiftvideo_tpu.net.rtmp, "
            "swiftvideo_tpu.core; print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr
