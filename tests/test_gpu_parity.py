"""GPU parity sweep: every device program at real widths against its
plain reference, compiled for the card.

Marked ``gpu``: the ``gpu`` fixture skips these where JAX's default device
is not a GPU.  Run on a GPU host from the repository root with::

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_parity.py

The checks are chip_smoke.py's own (one definition of each tolerance);
the CPU suite runs the same functions at tiny sizes
(tests/test_chip_smoke.py).
"""

import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("check", cs.PARITY_CHECKS,
                         ids=[fn.__name__ for fn in cs.PARITY_CHECKS])
def test_parity_at_real_width(gpu, check):
    check()


def test_station_1080p(gpu):
    res = cs.phase_station()
    assert res["emitted"] == res["ticks"] >= 70


def test_warp_device_matches_numpy_plan(gpu):
    """Compiled warp cascade vs the numpy plan on the same geometry
    (rolls, hat matmuls, on-device table build).  The matmuls run at
    Precision.HIGH, one TF32 pass on the H100: two hat stages bound the
    difference from the f64 plan by ~0.31 of an LSB (ops/matscale.py's
    precision note), inside the <=1 LSB composite contract."""
    from swiftvideo_tpu.ops import rect_uniforms
    from swiftvideo_tpu.ops.warp import plan_warp, warp_sample_device
    yy, xx = np.mgrid[0:540, 0:960]
    src = np.clip(127 + 80 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
                  + 0.05 * xx, 0, 255).astype(np.uint8)
    for deg in (0.3, 1.1):
        u = rect_uniforms((960, 540), (1920, 1080), x=300.4, y=200.7,
                          w=900, h=500, rotation=deg).pack()
        plan = plan_warp(u, 1080, 1920, 540, 960)
        assert plan is not None
        err = np.abs(plan.sample(src, np) - np.asarray(
            warp_sample_device(plan, src))).max()
        assert err < 0.32, (deg, err)


def test_packed_422_composite(gpu):
    from swiftvideo_tpu.media import PixelFormat
    from swiftvideo_tpu.ops import composite, golden, rect_uniforms
    rng = np.random.default_rng(41)
    src = rng.integers(0, 256, (540, 960, 2), np.uint8)
    uni = rect_uniforms((960, 540), (1920, 1080), x=120.3, y=80.7,
                        w=1400.4, h=800.2, opacity=0.9)
    for fmt in (PixelFormat.yuvs, PixelFormat.zvuy):
        sources = [([src], fmt, uni)]
        ref = golden.composite_stack(fmt, (1920, 1080), sources)
        dev = composite.composite_stack_device(fmt, (1920, 1080), sources)
        cs.assert_lsb(f"packed 4:2:2 {fmt.name}", dev, ref)


def test_motion_pyramid(gpu):
    from swiftvideo_tpu.ops import motion
    rng = np.random.default_rng(33)
    ref = rng.integers(0, 255, (1080, 1920), np.uint8)
    cur = np.roll(ref, (6, 4), axis=(0, 1))
    ssd = np.asarray(motion.me_fullsearch_device(cur, ref, 16, 64,
                                                 metric="ssd"))
    pyr = np.asarray(motion.me_fullsearch_pyramid(cur, ref, 16, 64))
    assert np.array_equal(pyr[2:-2, 2:-2], ssd[2:-2, 2:-2])
