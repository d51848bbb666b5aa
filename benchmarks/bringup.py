"""GPU bring-up measurements of the plain-XLA device programs (the
numbers PERF.md's bring-up findings quote).

Prints one JSON object per line, each naming the card and its power limit:

* ``tick``: the mixer's 4-source 1080p y420p tick (BASELINE config 3):
  host time per tick through ``composite.composite_tick``, device time of
  the jitted program alone, kernels per tick and their summed device time
  from one ``jax.profiler`` trace, and the bytes the tick must move
  against the card's peak bandwidth;
* ``motion``: motion search 1080p / block 16 / search 64, every XLA
  formulation the registry can reach (exact SAD scan, SSD ungrouped and
  grouped);
* ``samplers``: each gather-avoiding XLA formulation against the plain
  gather it was built to replace (axis-split vs 2-D gather, phased vs gather,
  banded hat matmuls vs gather, shear-cascade warp vs exact gather);
* ``copy``: a large device copy, the bandwidth a memory-bound kernel can
  reach on this card.

Run on the GPU from the repository root:

    python benchmarks/bringup.py [--trace-dir chiprun_out/trace]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import card, peaks  # noqa: E402  (the one peaks table)


def emit(kind: str, **rec) -> None:
    print(json.dumps({"kind": kind, "card": CARD, **rec}), flush=True)


def time_ms(fn, *args, iters: int = 50, warmup: int = 3):
    """Median and min wall ms per call, each call ended by
    block_until_ready."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3), float(np.min(ts) * 1e3)


def device_ops(trace_dir: str, n_calls: int):
    """Kernels per call and their summed device ms per call, from the
    trace's GPU stream lines (memcpy/memset events counted apart)."""
    import jax
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    kernels, copies, busy_ns, names = 0, 0, 0, {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                if ev.name.startswith(("Memcpy", "Memset", "memcpy",
                                       "memset")):
                    copies += 1
                    continue
                kernels += 1
                busy_ns += ev.duration_ns
                names[ev.name] = names.get(ev.name, 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return (kernels / n_calls, copies / n_calls, busy_ns / n_calls / 1e6,
            top)


def quad_scene(w: int = 1920, h: int = 1080, n: int = 4, seed: int = 0):
    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import rect_uniforms
    rng = np.random.default_rng(seed)
    srcs = []
    for s in range(n):
        planes = [rng.integers(0, 256, (h, w), np.uint8),
                  rng.integers(0, 256, (h // 2, w // 2), np.uint8),
                  rng.integers(0, 256, (h // 2, w // 2), np.uint8)]
        srcs.append((planes, PixelFormat.y420p, rect_uniforms(
            (w, h), (w, h), x=(s % 2) * w / 2, y=(s // 2) * h / 2,
            w=w / 2, h=h / 2, opacity=0.9,
            fill_color=(0.1, 0.2, 0.3, 0.5))))
    return srcs


def measure_tick(trace_dir: str) -> None:
    import jax
    import jax.numpy as jnp

    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import composite

    w, h = 1920, 1080
    srcs = quad_scene(w, h)
    dsrcs = [([jnp.asarray(p) for p in pl], f, u) for pl, f, u in srcs]
    host_med, host_min = time_ms(
        lambda: composite.composite_tick(PixelFormat.y420p, (w, h), dsrcs))
    program, args = composite.batched_boxed_program((w, h), dsrcs)
    dev_med, dev_min = time_ms(program, *args, iters=200)
    n = 20
    jax.block_until_ready(program(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(n):
            out = program(*args)
        jax.block_until_ready(out)
    kernels, copies, kern_ms, top = device_ops(trace_dir, n)
    frame = w * h * 3 // 2
    moved = 4 * frame + frame          # 4 sources read + target written
    peak = peaks()["hbm_gbps"] * 1e9
    nv_med, nv_min = time_ms(lambda: composite.composite_tick(
        PixelFormat.nv12, (w, h), dsrcs))
    emit("tick", scene="4 x 1080p y420p quadrants -> 1080p y420p",
         host_ms_median=host_med, host_ms_min=host_min,
         program_ms_median=dev_med, program_ms_min=dev_min,
         kernels_per_tick=kernels, copies_per_tick=copies,
         kernel_ms_per_tick=kern_ms, bytes_per_tick=moved,
         kernel_gbps=moved / (kern_ms * 1e-3) / 1e9,
         kernel_share_of_peak=moved / (kern_ms * 1e-3) / peak,
         program_gbps=moved / (dev_min * 1e-3) / 1e9,
         bound_us=moved / peak * 1e6, top_kernels=top,
         nv12_host_ms_median=nv_med, nv12_host_ms_min=nv_min)


def measure_motion() -> None:
    import jax
    import jax.numpy as jnp

    from swiftvideo_tpu.ops import motion

    h, w = 1080, 1920
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 255, (h, w), np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-12, 12, ref.shape), 0,
                  255).astype(np.uint8)
    c, r = jnp.asarray(cur), jnp.asarray(ref)
    outs = {}
    for name, prog in (
            ("sad_scan", lambda: motion._me_program(h, w, 16, 64)),
            ("ssd_ungrouped", lambda: motion._me_mxu_program(h, w, 16, 64)),
            ("ssd_grouped", lambda: motion._me_mxu_program(h, w, 16, 64,
                                                           True))):
        try:
            t0 = time.perf_counter()
            p = prog()
            outs[name] = np.asarray(jax.block_until_ready(p(c, r)))
            first = time.perf_counter() - t0
            med, mn = time_ms(p, c, r, iters=10, warmup=1)
            emit("motion", variant=name, geometry="1080p/16/64",
                 first_call_s=first, ms_median=med, ms_min=mn)
        except Exception as exc:  # noqa: BLE001 - a failed variant is data
            emit("motion", variant=name, geometry="1080p/16/64",
                 error=f"{type(exc).__name__}: {str(exc)[:300]}")
    ssd = [v for k, v in outs.items() if k.startswith("ssd")]
    emit("motion", variant="ssd_agreement",
         all_equal=all(np.array_equal(ssd[0], o) for o in ssd[1:]))


def measure_samplers() -> None:
    import jax
    import jax.numpy as jnp

    from swiftvideo_tpu.media.pixel import PixelFormat
    from swiftvideo_tpu.ops import composite, golden, identity_uniforms, \
        rect_uniforms
    from swiftvideo_tpu.ops.matscale import plan_scale, scale_y420p

    w, h = 1920, 1080
    rng = np.random.default_rng(3)
    src = [jnp.asarray(rng.integers(0, 256, s, np.uint8))
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    uni = jnp.asarray(rect_uniforms((w, h), (w, h), x=100.3, y=50.7,
                                    w=1280, h=720, opacity=0.9).pack())

    def one(separable):
        @jax.jit
        def run(planes, u):
            target = [jnp.zeros((h, w), jnp.uint8),
                      jnp.full((h // 2, w // 2), 128, jnp.uint8),
                      jnp.full((h // 2, w // 2), 128, jnp.uint8)]
            return golden.apply_composite(target, PixelFormat.y420p,
                                          list(planes), PixelFormat.y420p,
                                          u, xp=jnp, separable=separable)
        return time_ms(run, tuple(src), uni, iters=30)[1]

    emit("samplers", what="axis-split vs 2-D gather, 1080p source",
         axis_split_ms=one(True), gather_2d_ms=one(False))

    srcs = quad_scene(w, h)
    dsrcs = [([jnp.asarray(p) for p in pl], f, u) for pl, f, u in srcs]
    packed = [np.asarray(golden._packed(u)) for _, _, u in srcs]
    phases = composite._phase_info(packed, (w, h), (h, w))
    program, args = composite.batched_boxed_program((w, h), dsrcs)
    boxes = [composite._host_box_size(p, (w, h)) for p in packed]
    box = (max(b[0] for b in boxes), max(b[1] for b in boxes))
    phased = composite._stack_program_batched_boxed((w, h), 4, box, (h, w),
                                                    phases)
    emit("samplers", what="phased gather-free vs gather, 4-source tick",
         phases=str(phases), gather_ms=time_ms(program, *args)[1],
         phased_ms=time_ms(phased, *args)[1])

    for rung in ((1280, 720), (854, 480), (640, 360)):
        rw, rh = rung[0] // 2 * 2, rung[1] // 2 * 2
        u = identity_uniforms((w, h), (rw, rh))
        plan = plan_scale(u, (rw, rh), (h, w))
        mat = jax.jit(lambda p, plan=plan: scale_y420p(p, plan))
        gat = jax.jit(lambda p, u=jnp.asarray(u.pack()), rw=rw, rh=rh:
                      golden.apply_composite(
                          [jnp.zeros((rh, rw), jnp.uint8),
                           jnp.full((rh // 2, rw // 2), 128, jnp.uint8),
                           jnp.full((rh // 2, rw // 2), 128, jnp.uint8)],
                          PixelFormat.y420p, list(p), PixelFormat.y420p, u,
                          xp=jnp, separable=True))
        emit("samplers", what=f"hat-matmul vs gather, 1080p->{rw}x{rh}",
             matscale_ms=time_ms(mat, tuple(src), iters=30)[1],
             gather_ms=time_ms(gat, tuple(src), iters=30)[1])

    yy, xx = np.mgrid[0:h, 0:w]
    sm = np.clip(127 + 80 * np.sin(xx / 23.0) * np.cos(yy / 17.0), 0,
                 255).astype(np.uint8)
    rot = [([jnp.asarray(sm), jnp.asarray(sm[::2, ::2]),
             jnp.asarray(sm[1::2, ::2])], PixelFormat.y420p,
            rect_uniforms((w, h), (w, h), x=200.4, y=100.7, w=1400,
                          h=800, rotation=0.35, opacity=0.9))]
    warp = time_ms(lambda: composite.composite_stack_boxed(
        PixelFormat.y420p, (w, h), rot, exact_rotation=False), iters=20)
    exact = time_ms(lambda: composite.composite_stack_boxed(
        PixelFormat.y420p, (w, h), rot, exact_rotation=True), iters=20)
    ref = golden.composite_stack(PixelFormat.y420p, (w, h),
                                 [([np.asarray(p) for p in rot[0][0]],
                                   PixelFormat.y420p, rot[0][2])])
    errs = {}
    for name, exact_rot in (("warp", False), ("exact", True)):
        out = composite.composite_stack_boxed(PixelFormat.y420p, (w, h),
                                              rot, exact_rotation=exact_rot)
        e = np.abs(np.asarray(out[0]).astype(int) - ref[0].astype(int))
        errs[name] = [int(e.max()), float(np.percentile(e, 90)),
                      float((e > 4).mean())]
    emit("samplers", what="rotated 1080p source: shear-cascade warp vs "
         "exact gather (host ms per tick; errors max/p90/frac>4 on luma)",
         warp_ms_median=warp[0], warp_ms_min=warp[1],
         exact_ms_median=exact[0], exact_ms_min=exact[1], errors=errs)


def measure_copy() -> None:
    import jax
    import jax.numpy as jnp
    x = jnp.ones((1 << 28,), jnp.float32)          # 1 GiB
    f = jax.jit(lambda a: a + 1.0)
    med, mn = time_ms(f, x, iters=20)
    emit("copy", bytes=2 * x.nbytes, ms_min=mn,
         gbps=2 * x.nbytes / (mn * 1e-3) / 1e9)


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=os.path.join(
        "chiprun_out", "trace"))
    args = ap.parse_args()
    import jax

    from swiftvideo_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bringup.py measures the GPU; JAX found "
                         f"{jax.devices()[0]}")
    enable_compile_cache()
    CARD = card()
    emit("device", device_kind=jax.devices()[0].device_kind,
         jax=jax.__version__)
    for fn in (measure_copy, lambda: measure_tick(args.trace_dir),
               measure_samplers, measure_motion):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - report and go on
            emit("error", where=getattr(fn, "__name__", "?"),
                 error=f"{type(exc).__name__}: {str(exc)[:500]}")
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
