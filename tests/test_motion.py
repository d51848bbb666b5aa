"""Motion search's XLA programs against the scalar oracles.

Both device formulations the registry reaches — the exact-SAD scan
(``_me_program``) and the SSD matmul variant (``_me_mxu_program``) — must
be candidate-exact, including clamped edge windows, truncated right/bottom
windows, frame heights that are not a whole number of block rows and a
wide frame, and must recover a global translation.
"""

import numpy as np
import pytest

from swiftvideo_tpu.ops import motion

GEOMETRIES = [(96, 128, 64), (128, 256, 64), (120, 128, 32),
              (96, 160, 64), (64, 128, 64), (96, 96, 32), (128, 2048, 64)]

PROGRAMS = {
    "sad": (motion._me_program, motion.me_fullsearch_golden),
    "ssd": (motion._me_mxu_program, motion.me_ssd_golden),
}


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 255, (h, w), np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-12, 12, ref.shape),
                  0, 255).astype(np.uint8)
    return cur, ref


@pytest.mark.parametrize("metric", sorted(PROGRAMS))
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_motion_program_matches_oracle(geom, metric):
    h, w, search = geom
    cur, ref = _pair(h, w, h + w + search)
    program, oracle = PROGRAMS[metric]
    out = np.asarray(program(h, w, 16, search)(cur, ref))
    assert np.array_equal(oracle(cur, ref, 16, search), out)


@pytest.mark.parametrize("metric", sorted(PROGRAMS))
@pytest.mark.parametrize("shift", [(6, 6), (4, -2)])
def test_motion_program_recovers_translation(shift, metric):
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 255, (128, 128), np.uint8)
    cur = np.roll(ref, shift, axis=(0, 1))
    program, _ = PROGRAMS[metric]
    out = np.asarray(program(128, 128, 16, 64)(cur, ref))
    dy, dx = shift
    inner = out[2:6, 2:6]
    assert np.all(inner[..., 0] == int(round((dx / 32 * 0.5 + 0.5) * 255)))
    assert np.all(inner[..., 2] == int(round((dy / 32 * 0.5 + 0.5) * 255)))


def test_motion_device_routes_metrics():
    """``me_fullsearch_device`` runs the scan for SAD and the ungrouped
    conv for SSD (the faster formulation on the GPU, PERF.md)."""
    cur, ref = _pair(64, 128, 3)
    sad = np.asarray(motion.me_fullsearch_device(cur, ref, 16, 64))
    ssd = np.asarray(motion.me_fullsearch_device(cur, ref, 16, 64,
                                                 metric="ssd"))
    assert np.array_equal(
        sad, np.asarray(motion._me_program(64, 128, 16, 64)(cur, ref)))
    assert np.array_equal(
        ssd, np.asarray(motion._me_mxu_program(64, 128, 16, 64)(cur, ref)))
