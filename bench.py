"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline (BASELINE config 3): fused 1080p 4-source csc+scale+composite
frames/sec on the GPU, including the clear pass, at golden-oracle parity
(<=1 LSB, asserted on one frame before timing).  ``vs_baseline`` is
measured against the original brief's target of 4000 fps (BASELINE.md).

Secondary configs (printed to stderr): 720p->360p convert+scale, audio
resample Msamples/s, transcode-ladder scale set, mixing wall, motion
search, RTMP/flavor ingest.  Every result names the card and its power
limit; a device without published peaks in ``PEAKS`` is an error.
"""

import json
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def time_fn(fn, *args, iters=50, warmup=2):
    import jax
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


#: rep-level slopes of the most recent labeled time_device_loop call (the
#: min is the device capability, the spread is the noise evidence)
LAST_REP_SLOPES = {}


def time_device_loop(make_body, init, iters=100, warmup=True, reps=3,
                     label=None):
    """Time pure device execution by SLOPE: one jitted lax.fori_loop with a
    carried data dependency, run at two trip counts; the (T2-T1)/(N2-N1)
    difference cancels every fixed cost — dispatch latency, host-fetch
    latency, compile cache checks — which otherwise inflate per-iter
    numbers.  Min over ``reps``: the min is the estimate of device
    capability.  ``label`` records the
    per-rep slopes in LAST_REP_SLOPES and logs them, so the recorded
    number carries its own variance evidence (VERDICT r3 item #5a)."""
    import jax
    import numpy as np

    @jax.jit
    def run(carry, n):
        out = jax.lax.fori_loop(0, n, make_body, carry)
        return out

    def wall(n):
        t0 = time.perf_counter()
        out = run(init, n)
        for leaf in jax.tree.leaves(out):
            if hasattr(leaf, "shape") and leaf.ndim >= 1:
                np.asarray(leaf[(slice(0, 1),) * leaf.ndim])
                break
        else:
            jax.block_until_ready(out)
        return time.perf_counter() - t0

    n1, n2 = max(iters // 5, 2), iters
    if warmup:
        wall(2)
    slopes = []
    t1s, t2s = [], []
    for _ in range(max(1, reps)):
        t1 = wall(n1)
        t2 = wall(n2)
        t1s.append(t1)
        t2s.append(t2)
        if t2 > t1:
            slopes.append((t2 - t1) / (n2 - n1))
    # estimator: (min t2 - min t1) / (n2 - n1).  Each min is the least-
    # contended observation of its trip count, so the difference is the
    # clean-window device slope; unlike min-of-pairwise-slopes it cannot
    # be deflated by a rep whose t1 was contention-inflated while its t2
    # was clean.
    if t1s and t2s and min(t2s) > min(t1s):
        best = (min(t2s) - min(t1s)) / (n2 - n1)
    elif slopes:
        best = min(slopes)
    else:
        best = wall(n2) / n2
        slopes.append(best)
    if label is not None:
        LAST_REP_SLOPES[label] = slopes or [best]
        log(f"{label} rep slopes (ms): "
            + "[" + ", ".join(f"{s*1e3:.3f}" for s in slopes) + "]"
            + (f" spread {max(slopes)/min(slopes):.2f}x"
               if slopes else "")
            + f"; min-t estimator {best*1e3:.3f}")
    return best


#: published peaks per ``device_kind`` (NVIDIA H100 SXM data sheet, dense
#: rates): device-memory GB/s and bf16 tensor-core TFLOP/s
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0}}


def peaks() -> dict:
    import jax
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       "add them to bench.PEAKS")
    return PEAKS[kind]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()


#: extra per-config detail accumulated for the output JSON
CONFIGS = {}


def roofline(name, dt, in_bytes, out_bytes):
    """Record + log achieved bandwidth vs the card's peak.  Bytes are
    the algorithm's obligatory traffic (sources read once + target written
    once); a fused kernel can't go below it, so GB/s here is a floor on
    achieved bandwidth and % is how close the kernel is to speed-of-light
    for this memory-bound workload."""
    gbps = (in_bytes + out_bytes) / dt / 1e9
    pct = 100.0 * gbps / peaks()["hbm_gbps"]
    CONFIGS.setdefault(name, {})
    CONFIGS[name].update({
        "ms": round(dt * 1e3, 4),
        "gbps": round(gbps, 1),
        "hbm_pct": round(pct, 1),
        "mb_per_it": round((in_bytes + out_bytes) / 1e6, 2)})
    log(f"{name} roofline: {(in_bytes+out_bytes)/1e6:.2f} MB/it at "
        f"{dt*1e3:.3f} ms = {gbps:.0f} GB/s ({pct:.1f}% of peak)")
    return gbps, pct


def record_spread(name):
    sl = LAST_REP_SLOPES.get(name)
    if sl:
        CONFIGS.setdefault(name, {})
        CONFIGS[name]["rep_ms"] = [round(s * 1e3, 4) for s in sl]
        CONFIGS[name]["rep_spread"] = round(max(sl) / min(sl), 2)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import golden, rect_uniforms, identity_uniforms
    from swiftvideo_tpu.ops.resample import PolyphaseResampler  # noqa: F401

    from swiftvideo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {dev}")
    peaks()
    card_line = card()
    log("devices:", jax.devices(), "card:", card_line)
    rng = np.random.default_rng(0)

    # ---- headline: 4-source 1080p composite (config 3) -------------------
    H, W = 1080, 1920
    n_sources = 4
    sources = []
    unis = []
    for s in range(n_sources):
        sources.append([
            rng.integers(0, 256, (H, W), np.int64).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2), np.int64).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2), np.int64).astype(np.uint8)])
        unis.append(rect_uniforms((W, H), (W, H), x=(s % 2) * 960,
                                  y=(s // 2) * 540, w=960, h=540,
                                  opacity=0.9, fill_color=(0.1, 0.2, 0.3, 0.5)
                                  ).pack())

    dev_sources = [tuple(jnp.asarray(p) for p in planes) for planes in sources]
    dev_unis = jnp.asarray(np.stack(unis))

    from swiftvideo_tpu.ops.composite import (_host_box_size,
                                              _stack_program_batched_boxed)
    boxes = [_host_box_size(u, (W, H)) for u in unis]
    box = (max(b[0] for b in boxes), max(b[1] for b in boxes))
    log("box bucket:", box)
    _prog = _stack_program_batched_boxed((W, H), n_sources, box, (H, W))
    ys4 = jnp.stack([p[0] for p in dev_sources])
    us4 = jnp.stack([p[1] for p in dev_sources])
    vs4 = jnp.stack([p[2] for p in dev_sources])

    def composite_frame(_src_unused, uniforms):
        return _prog(ys4, us4, vs4, uniforms)

    # parity check vs the numpy oracle before timing
    dev_out = composite_frame(tuple(dev_sources), dev_unis)
    ref = golden.composite_stack(
        PixelFormat.y420p, (W, H),
        [(sources[i], PixelFormat.y420p, unis[i]) for i in range(n_sources)])
    max_err = max(int(np.abs(np.asarray(d).astype(int) - r.astype(int)).max())
                  for d, r in zip(dev_out, ref))
    log("parity max pixel err:", max_err)
    assert max_err <= 1, f"parity failure: {max_err}"

    # pure device-time measurement: fold frames inside one fori_loop with a
    # carried data dependency (the previous frame perturbs one uniform
    # lane), so neither dispatch latency nor cross-iteration parallelism
    # can distort the number
    def frame_body(_k, carry):
        planes, unis = carry
        out = composite_frame(tuple(dev_sources), unis)
        bump = (out[0][0, 0].astype(jnp.float32) * 1e-12)
        return (out, unis + bump)

    init = (composite_frame(tuple(dev_sources), dev_unis), dev_unis)
    dt = time_device_loop(frame_body, init, iters=100, label="config3-xla")
    fps = 1.0 / dt
    late_probe_ladder = None  # (body, init, dt) for the config4 re-measure

    # headline traffic: 4 sources read + 1 target written, y420p
    HL_IN = 4 * (H * W + 2 * (H // 2) * (W // 2))
    HL_OUT = H * W + 2 * (H // 2) * (W // 2)
    roofline("config3-xla", dt, HL_IN, HL_OUT)
    record_spread("config3-xla")

    log(f"config3 4-source 1080p composite (XLA fold): {dt*1e3:.3f} ms/frame = {fps:.1f} fps (device loop)")

    # ---- config 1: 720p y420p -> RGBA convert + downscale to 360p --------
    src720 = [jnp.asarray(rng.integers(0, 256, (720, 1280), np.int64).astype(np.uint8)),
              jnp.asarray(rng.integers(0, 256, (360, 640), np.int64).astype(np.uint8)),
              jnp.asarray(rng.integers(0, 256, (360, 640), np.int64).astype(np.uint8))]
    uni1 = jnp.asarray(identity_uniforms((1280, 720), (640, 360)).pack())

    @jax.jit
    def convert_scale(planes, uni):
        target = [jnp.zeros((360, 640, 4), jnp.uint8)]
        target[0] = target[0].at[..., 3].set(255)
        return golden.apply_composite(target, PixelFormat.RGBA, list(planes),
                                      PixelFormat.y420p, uni, xp=jnp,
                                      separable=True)[0]

    dt1 = time_fn(convert_scale, tuple(src720), uni1, iters=100)
    log(f"config1 720p->360p RGBA convert (XLA): {dt1*1e3:.3f} ms = {1/dt1:.1f} fps")
    # ---- config 4: transcode ladder 1080p -> {720p, 480p, 360p} ----------
    # matmul-sampler (ops/matscale.py): each rung = V @ X @ H banded
    # matmuls; parity vs the golden oracle asserted before timing
    from swiftvideo_tpu.ops.matscale import plan_scale, scale_y420p
    src1080 = dev_sources[0]
    rungs = ((1280, 720), (854, 480), (640, 360))
    plans = [plan_scale(identity_uniforms((W, H), r), r, (H, W))
             for r in rungs]

    @jax.jit
    def ladder(planes):
        return tuple(scale_y420p(planes, p) for p in plans)

    lad_out = ladder(src1080)
    for (w, h), out in zip(rungs, lad_out):
        uni = identity_uniforms((W, H), (w, h))
        ref = golden.composite_stack(
            PixelFormat.y420p, (w, h),
            [(sources[0], PixelFormat.y420p, uni)])
        e4 = max(int(np.abs(np.asarray(o).astype(int) - r.astype(int)).max())
                 for o, r in zip(out, ref))
        assert e4 <= 1, f"ladder parity failure at {(w, h)}: {e4}"

    def ladder_body(_k, carry):
        planes, _ = carry
        out = ladder(planes)
        # write one emitted pixel back into the source so the whole rung
        # computation is loop-carried (an integer *0 bump would be
        # constant-folded and the ladder hoisted out of the loop)
        y2 = planes[0].at[0, 0].set(out[0][0][0, 0])
        return ((y2, planes[1], planes[2]), out)

    dt4 = time_device_loop(ladder_body, (src1080, lad_out), iters=100,
                           reps=6, label="config4-ladder")
    log(f"config4 1080p ladder (3 rungs): {dt4*1e3:.3f} ms = {1/dt4:.1f} ladders/s")
    lad_out_bytes = sum(w * h + 2 * (w // 2) * (h // 2) for w, h in rungs)
    roofline("config4-ladder", dt4,
             3 * (W * H + 2 * (W // 2) * (H // 2)),  # source read per rung
             lad_out_bytes)
    record_spread("config4-ladder")
    late_probe_ladder = (ladder_body, (src1080, lad_out), dt4)

    # ---- config 2: audio resample throughput ------------------------------
    # batched-stream device loop (the wall-serving shape): 64 stereo streams,
    # one second each, windows+filter-matmul per iteration
    from swiftvideo_tpu.ops.resample import design_polyphase
    Hf, r0, L, M = design_polyphase(44100, 48000)
    R = Hf.shape[1]
    n_streams = 64 * 2  # stereo channels
    n_in = 44100
    cycles = (n_in - R) // M
    starts = jnp.asarray((np.arange(cycles) * M).astype(np.int32))
    Hj = jnp.asarray(Hf)
    xa = jnp.asarray(rng.standard_normal((n_streams, n_in)).astype(np.float32))

    def resample_body(_k, x):
        idx = starts[:, None] + jnp.arange(R)[None, :]
        win = jnp.take(x, idx, axis=-1)
        y = jnp.einsum("pcr,lr->pcl", win, Hj, precision="highest",
                       preferred_element_type=jnp.float32)
        # feed a whisper of EVERY output back to keep the loop sequential:
        # a single-element probe lets XLA dead-code-eliminate the rest of
        # the einsum and report phantom throughput
        return x + jnp.sum(y, axis=(1, 2))[:, None] * 1e-20

    # this kernel is microseconds per iteration: 2000 iterations put
    # enough device time in the slope delta to rise above host jitter
    dt2 = time_device_loop(resample_body, xa, iters=2000, reps=6,
                           label="config2-resample")
    msps = n_streams * cycles * M / dt2 / 1e6
    log(f"config2 resample 44.1->48k ({n_streams} ch batched): "
        f"{msps:.0f} Msamples/s")
    # obligatory traffic lower bound: streams in + resampled out, f32
    roofline("config2-resample", dt2, int(xa.nbytes),
             n_streams * cycles * L * 4)
    record_spread("config2-resample")
    CONFIGS["config2-resample"]["msamples_s"] = round(msps, 1)

    # ---- config 5: 64-stream 1080p mixing wall (single-chip slice) --------
    try:
        from swiftvideo_tpu.parallel import MixingWall, make_mesh
        mesh = make_mesh(jax.devices()[:1])
        wall = MixingWall(mesh, n_streams=64, stream_size=(1920, 1080),
                          canvas_size=(1920, 1088), audio_samples=800)  # 1088: 8x8 grid needs even tile heights
        ys = wall.shard(jnp.asarray(rng.integers(
            0, 256, (64, 1080, 1920), np.int64).astype(np.uint8)))
        us = wall.shard(jnp.full((64, 540, 960), 128, jnp.uint8))
        vs = wall.shard(jnp.full((64, 540, 960), 128, jnp.uint8))
        audio = wall.shard(jnp.full((64, 1600), 50, jnp.int16))
        gains = jnp.ones((64,), jnp.float32)

        def wall_body(_k, carry):
            ys_c, us_c, vs_c, au_c, _prev = carry
            out = wall._step_plan(ys_c, us_c, vs_c, au_c, gains)
            # loop-carry one probe pixel of every output into its input so
            # NO path (luma, chroma, audio) is loop-invariant — a constant
            # us/vs/audio lets XLA hoist the whole chroma scale + audio mix
            # out of the loop and the "tick" times only the Y plane
            ys2 = ys_c.at[0, 0, 0].set(out[0][0, 0])
            us2 = us_c.at[0, 0, 0].set(out[1][0, 0])
            vs2 = vs_c.at[0, 0, 0].set(out[2][0, 0])
            au2 = au_c.at[0, 0].set(out[3].reshape(-1)[0])
            # carry the full wall planes too: a one-pixel probe would let
            # XLA prune most tiles' matmuls
            return (ys2, us2, vs2, au2, (out[0], out[1], out[2], out[3]))

        wall0 = wall.step(ys, us, vs, audio)
        init = (ys, us, vs, audio, (wall0[0], wall0[1], wall0[2], wall0[3]))
        dt5 = time_device_loop(wall_body, init, iters=50, reps=6,
                               label="config5-wall")
        log(f"config5 64-stream 1080p wall tick: {dt5*1e3:.3f} ms = "
            f"{1/dt5:.1f} wall fps = {64/dt5:.0f} stream-scales/s/chip")
        roofline("config5-wall", dt5,
                 sum(int(a.nbytes) for a in (ys, us, vs, audio)),
                 sum(int(o.nbytes) for o in wall0[:4]))
        record_spread("config5-wall")
    except Exception as exc:  # noqa: BLE001
        log("config5 wall failed:", exc)

    # config 6: 1080p motion estimation, block 16 / search 64 (the Metal
    # me_fullsearch workload, kernels.metal:206-267)
    # inputs shared by every ME variant, built outside their try blocks
    rng = np.random.default_rng(11)
    ref_f = rng.integers(0, 255, (1080, 1920), np.uint8)
    cur_f = np.clip(ref_f.astype(int)
                    + rng.integers(-12, 12, ref_f.shape),
                    0, 255).astype(np.uint8)
    curd, refd = jnp.asarray(cur_f), jnp.asarray(ref_f)
    try:
        from swiftvideo_tpu.ops import motion

        prog = motion._me_program(1080, 1920, 16, 64)

        def me_body(i, carry):
            c, r, _prev = carry
            out = prog(c, r)
            # carry the FULL MV field: a single-element probe could let
            # XLA narrow the search to one block's window
            return (c.at[0, 0].set(out[0, 0, 0]), r, out)

        dt6 = time_device_loop(me_body, (curd, refd, prog(curd, refd)),
                               iters=20, label="config6-sad")
        log(f"config6 1080p ME 16/64 (exact SAD): {dt6*1e3:.3f} ms/frame = "
            f"{1/dt6:.1f} fps")
        record_spread("config6-sad")
    except Exception as exc:  # noqa: BLE001
        log("config6 motion failed:", exc)
    try:
        from swiftvideo_tpu.ops import motion
        prog_s = motion._me_mxu_program(1080, 1920, 16, 64)

        def me_body_s(i, carry):
            c, r, _prev = carry
            out = prog_s(c, r)
            return (c.at[0, 0].set(out[0, 0, 0]), r, out)

        dt6s = time_device_loop(me_body_s, (curd, refd, prog_s(curd, refd)),
                                iters=20, label="config6-ssd")
        log(f"config6 1080p ME 16/64 (SSD): {dt6s*1e3:.3f} ms/frame = "
            f"{1/dt6s:.1f} fps")
        record_spread("config6-ssd")
    except Exception as exc:  # noqa: BLE001
        log("config6 ssd motion failed:", exc)
    try:
        from swiftvideo_tpu.ops import motion
        prog_g = motion._me_mxu_program(1080, 1920, 16, 64, True)

        def me_body_g(i, carry):
            c, r, _prev = carry
            out = prog_g(c, r)
            return (c.at[0, 0].set(out[0, 0, 0]), r, out)

        dt6g = time_device_loop(me_body_g, (curd, refd, prog_g(curd, refd)),
                                iters=20, reps=6, label="config6-ssd-grouped")
        log(f"config6 1080p ME 16/64 (SSD grouped): "
            f"{dt6g*1e3:.3f} ms/frame = {1/dt6g:.1f} fps")
        record_spread("config6-ssd-grouped")
    except Exception as exc:  # noqa: BLE001
        log("config6 grouped ssd motion failed:", exc)
    try:
        from swiftvideo_tpu.ops import motion
        prog_p = motion._me_pyramid_program(1080, 1920, 16, 64, 2, "ssd")

        def me_body_p(i, carry):
            c, r, _prev = carry
            out = prog_p(c, r)
            return (c.at[0, 0].set(out[0, 0, 0]), r, out)

        dt6p = time_device_loop(me_body_p, (curd, refd, prog_p(curd, refd)),
                                iters=20, label="config6-pyramid")
        log(f"config6 1080p ME 16/64 (pyramid two-stage, experimental): "
            f"{dt6p*1e3:.3f} ms/frame = {1/dt6p:.1f} fps")
        record_spread("config6-pyramid")
    except Exception as exc:  # noqa: BLE001
        log("config6 pyramid motion failed:", exc)

    # ---- config 7 (host): RTMP loopback realtime multiple ----------------
    # the reference's only printed perf figure (rtmpTests.swift:100-106):
    # publish->serialize->TCP->deserialize->subscribe on localhost, media
    # seconds per wall second
    try:
        rate = _rtmp_realtime_multiple()
        log(f"config7 RTMP loopback: {rate:.1f}x realtime "
            f"(120 frames @16ms, 20 KB avg)")
    except Exception as exc:  # noqa: BLE001
        log("config7 rtmp loopback failed:", exc)
    try:
        rate = _flavor_realtime_multiple()
        log(f"config7b flavor loopback: {rate:.1f}x realtime "
            f"(120 frames @16ms, 20 KB avg)")
    except Exception as exc:  # noqa: BLE001
        log("config7b flavor loopback failed:", exc)
    try:
        n_pub = 16
        rate = _rtmp_multi_ingest_multiple(n_pub=n_pub)
        log(f"config7c {n_pub}-publisher aggregate: {rate:.1f}x realtime "
            f"= {rate/n_pub:.1f}x per stream (60 frames @16ms, 20 KB avg, "
            f"one event loop)")
    except Exception as exc:  # noqa: BLE001
        log("config7c multi-ingest failed:", exc)
    try:
        # the full BASELINE config-5 ingest shape on ONE core: the
        # aggregate plateaus at the per-core Python ceiling (~110x on
        # this host), so per-stream drops with N.  The production
        # mitigation is SO_REUSEPORT socket sharding, one worker process
        # per core (Rtmp.serve(reuse_port=True); correctness proven in
        # tests/test_ingest_sharding.py) — the reference gets the same
        # scale-out from SwiftNIO's threaded EventLoopGroup.
        n_pub = 64
        rate = _rtmp_multi_ingest_multiple(n_pub=n_pub, count=30)
        log(f"config7d {n_pub}-publisher aggregate: {rate:.1f}x realtime "
            f"= {rate/n_pub:.2f}x per stream (single core; scale out via "
            f"SO_REUSEPORT sharding, ~{rate:.0f}x per added core)")
    except Exception as exc:  # noqa: BLE001
        log("config7d 64-ingest failed:", exc)

    # ladder late window (VERDICT r4 item #4: config4's recorded swing
    # was unexplainable from one window; re-draw it like the headline)
    try:
        if late_probe_ladder is None:
            raise RuntimeError("config4 did not run")
        lad_body_l, lad_init_l, dt4_early = late_probe_ladder
        dt4l = time_device_loop(lad_body_l, lad_init_l, iters=100, reps=6,
                                label="config4-ladder-late")
        log(f"config4 1080p ladder (late window): {dt4l*1e3:.3f} ms = "
            f"{1/dt4l:.1f} ladders/s")
        record_spread("config4-ladder-late")
        CONFIGS["config4-ladder"]["best_ms"] = round(
            min(dt4_early, dt4l) * 1e3, 4)
        CONFIGS["config4-ladder"]["ladders_s"] = round(
            1.0 / min(dt4_early, dt4l), 1)
    except Exception as exc:  # noqa: BLE001
        log("late-window ladder re-measure failed:", exc)
    hl = LAST_REP_SLOPES.get("config3-xla", [])
    hl_gbps, hl_pct = roofline("headline", dt, HL_IN, HL_OUT)
    result = {
        "metric": "1080p 4-source csc+scale+composite fps",
        "value": round(fps, 1),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 4000.0, 3),
        "rep_fps": [round(1.0 / s, 1) for s in hl],
        "rep_spread": round(max(hl) / min(hl), 2) if hl else None,
        "hbm_gbps": round(hl_gbps, 1),
        "hbm_pct": round(hl_pct, 1),
        "card": card_line,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "configs": CONFIGS,
    }
    print(json.dumps(result))



def _rtmp_realtime_multiple(count: int = 120, frame_ms: int = 16) -> float:
    """Publish->TCP->subscribe loopback; returns media-time/wall-time."""
    import asyncio

    import numpy as np

    from swiftvideo_tpu.core import EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu.media.coded import (CodedMediaSample, MediaFormat,
                                            MediaType)
    from swiftvideo_tpu.net.rtmp import Rtmp

    async def run() -> float:
        clock = StepClock(TimePoint(frame_ms, 1000))
        received = []
        keep = {}

        async def on_connection(pub, sub):
            if sub is not None:
                keep["chain"] = sub >> Tx(
                    lambda s: (received.append(s), EventBox.nothing(None))[1])
            return True

        server = Rtmp(clock, on_connection=on_connection)
        await server.serve("127.0.0.1", 15907)
        client = Rtmp(clock)
        pub, _ = await client.connect("rtmp://127.0.0.1:15907/bench/stream",
                                      publish_to_peer=True, max_attempts=2,
                                      retry_delay=0.2)
        rng = np.random.default_rng(1)
        bufs = []
        for _ in range(4):
            data = bytearray(rng.integers(0, 256, 19997).astype(np.uint8)
                             .tobytes())
            data[4] = 0x65       # keyframe NAL in AVCC framing
            bufs.append(bytes(data))
        for _ in range(14):          # metadata grace timer
            clock.step()
            await asyncio.sleep(0)
        config = bytes(48)
        ts = TimePoint(0, 1000)
        t0 = time.perf_counter()
        for i in range(count):
            sample = CodedMediaSample(
                buffer=bufs[i % 4], pts_value=ts, dts_value=ts,
                media_type=MediaType.video, media_format=MediaFormat.avc,
                id_asset="bench", id_workspace="bench",
                side={"config": config})
            pub.apply(EventBox.just(sample))
            ts = ts + TimePoint(frame_ms, 1000)
            clock.step()
            if i % 8 == 0:
                await asyncio.sleep(0)
        deadline = time.perf_counter() + 10.0
        while len(received) < count and time.perf_counter() < deadline:
            # sleep(0) still services the selector each loop turn; a 5 ms
            # poll would quantize the whole measurement
            await asyncio.sleep(0)
        wall = time.perf_counter() - t0
        await server.close()
        pub.close()
        if len(received) < count:
            raise RuntimeError(f"only {len(received)}/{count} arrived")
        return (count * frame_ms / 1000.0) / wall

    return asyncio.run(run())


def _rtmp_multi_ingest_multiple(n_pub: int = 16, count: int = 60,
                                frame_ms: int = 16) -> float:
    """N concurrent RTMP publishers into ONE server in one event loop —
    the reference's actual ingest shape (Examples/RtmpServer, BASELINE
    config 5's 64-stream feed), where pure-Python chunk parsing under the
    GIL is the suspected ceiling.  Returns the aggregate realtime
    multiple (sum of media seconds across sessions / wall); per-stream
    multiple = aggregate / n_pub.  Raises on any frame loss."""
    import asyncio

    import numpy as np

    from swiftvideo_tpu.core import EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu.media.coded import (CodedMediaSample, MediaFormat,
                                            MediaType)
    from swiftvideo_tpu.net.rtmp import Rtmp

    async def run() -> float:
        clock = StepClock(TimePoint(frame_ms, 1000))
        received: dict = {}
        keep = []

        async def on_connection(pub, sub):
            if sub is not None:
                lst = received.setdefault(sub.play_path(), [])
                keep.append(sub >> Tx(
                    lambda s, lst=lst: (lst.append(s),
                                        EventBox.nothing(None))[1]))
            return True

        server = Rtmp(clock, on_connection=on_connection)
        await server.serve("127.0.0.1", 15913)
        pubs = []
        for k in range(n_pub):
            client = Rtmp(clock)
            pub, _ = await client.connect(
                f"rtmp://127.0.0.1:15913/bench/cam{k}",
                publish_to_peer=True, max_attempts=2, retry_delay=0.2)
            pubs.append(pub)
        rng = np.random.default_rng(1)
        bufs = []
        for _ in range(4):
            data = bytearray(rng.integers(0, 256, 19997).astype(np.uint8)
                             .tobytes())
            data[4] = 0x65
            bufs.append(bytes(data))
        for _ in range(14):          # 224 ms metadata grace (clock time)
            clock.step()
            await asyncio.sleep(0)
        config = bytes(48)
        ts = TimePoint(0, 1000)
        t0 = time.perf_counter()
        for i in range(count):
            for k, pub in enumerate(pubs):
                sample = CodedMediaSample(
                    buffer=bufs[(i + k) % 4], pts_value=ts, dts_value=ts,
                    media_type=MediaType.video, media_format=MediaFormat.avc,
                    id_asset=f"cam{k}", id_workspace="bench",
                    side={"config": config})
                pub.apply(EventBox.just(sample))
            ts = ts + TimePoint(frame_ms, 1000)
            clock.step()
            await asyncio.sleep(0)
        deadline = time.perf_counter() + 30.0
        while (sum(len(v) for v in received.values()) < n_pub * count
               and time.perf_counter() < deadline):
            await asyncio.sleep(0)
        wall = time.perf_counter() - t0
        await server.close()
        for pub in pubs:
            pub.close()
        got = {k: len(v) for k, v in received.items()}
        if sum(got.values()) < n_pub * count:
            raise RuntimeError(f"frame loss: {got}")
        return (n_pub * count * frame_ms / 1000.0) / wall

    return asyncio.run(run())


def _flavor_realtime_multiple(count: int = 120, frame_ms: int = 16) -> float:
    """flavor push->TCP->subscribe loopback; media-time/wall-time (the
    protocol peer of config 7 — same workload over the atom wire)."""
    import asyncio

    import numpy as np

    from swiftvideo_tpu.core import EventBox, TimePoint, Tx
    from swiftvideo_tpu.media.coded import (CodedMediaSample, MediaFormat,
                                            MediaType)
    from swiftvideo_tpu.net import flavor as fl

    async def run() -> float:
        received = []
        keep = []

        def on_subscriber(sub):
            keep.append(sub)
            keep.append(sub >> Tx(
                lambda s: (received.append(s), EventBox.nothing(None))[1]))

        server = fl.Flavor(on_subscriber=on_subscriber)
        await server.serve("127.0.0.1", 15908)
        client = fl.Flavor()
        pub = await client.connect("flavor://127.0.0.1:15908/bench/stream",
                                   push=True)
        rng = np.random.default_rng(1)
        bufs = [bytes(rng.integers(0, 256, 19997).astype(np.uint8))
                for _ in range(4)]
        ts = TimePoint(0, 1000)
        t0 = time.perf_counter()
        for i in range(count):
            pub.apply(EventBox.just(CodedMediaSample(
                buffer=bufs[i % 4], pts_value=ts, dts_value=ts,
                media_type=MediaType.video, media_format=MediaFormat.avc,
                id_asset="bench", id_workspace="bench",
                side={"config": bytes(48)})))
            ts = ts + TimePoint(frame_ms, 1000)
            if i % 8 == 0:
                await asyncio.sleep(0)
        deadline = time.perf_counter() + 10.0
        while len(received) < count and time.perf_counter() < deadline:
            await asyncio.sleep(0)
        wall = time.perf_counter() - t0
        pub.close()
        await server.close()
        if len(received) < count:
            raise RuntimeError(f"only {len(received)}/{count} arrived")
        return (count * frame_ms / 1000.0) / wall

    return asyncio.run(run())


if __name__ == "__main__":
    main()
