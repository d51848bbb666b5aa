"""The mixer's XLA tick programs against ``golden.composite_stack``.

Every scene runs through ``composite.composite_tick`` (what VideoMixer
calls each tick: the batched-boxed fold for uniform y420p stacks, the
boxed fold otherwise) and through ``composite_stack_device`` (the plain
unboxed fold), and must match the oracle to <= 1 LSB.  Positions sit at
fractional offsets: an edge exactly on a pixel boundary is a knife edge
the f32 oracle and a device may assign to either side.
"""

import numpy as np
import pytest

from swiftvideo_tpu.media.pixel import PixelFormat
from swiftvideo_tpu.ops import composite, golden, identity_uniforms, \
    rect_uniforms

Y420P, NV12, NV21 = PixelFormat.y420p, PixelFormat.nv12, PixelFormat.nv21
RGBA, BGRA = PixelFormat.RGBA, PixelFormat.BGRA


def _planes(h, w, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (h, w), np.uint8),
            r.integers(0, 256, (h // 2, w // 2), np.uint8),
            r.integers(0, 256, (h // 2, w // 2), np.uint8)]


def _rgba(h, w, seed):
    return [np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                                 np.uint8)]


def _cam(size, canvas, seed, **rect):
    return (_planes(size[1], size[0], seed), Y420P,
            rect_uniforms(size, canvas, **rect))


def _label(size, canvas, seed, fmt=RGBA, **rect):
    return (_rgba(size[1], size[0], seed), fmt,
            rect_uniforms(size, canvas, **rect))


C = (256, 128)                     # canvas of most scenes


def unity_copy():
    return C, [_cam(C, C, 1, x=0, y=0, w=256, h=128)]


def unity_overlap():
    return C, [_cam((128, 64), C, 2, x=10.3, y=20.7, w=128, h=64,
                    opacity=0.8, fill_color=(0.3, 0.1, 0.6, 0.4)),
               _cam((128, 64), C, 3, x=60.5, y=40.1, w=128, h=64,
                    opacity=0.6)]


def quadrants_2to1():
    return C, [_cam(C, C, 10 + s, x=(s % 2) * 128 + 3.3,
                    y=(s // 2) * 64 + 2.7, w=128, h=64, opacity=0.9,
                    fill_color=(0.1, 0.2, 0.3, 0.5)) for s in range(4)]


def multiview(n):
    canvas = (240, 120)
    return canvas, [_cam(canvas, canvas, 20 + s,
                         x=(s % n) * 240 / n + 0.8, y=(s // n) * 120 / n + 0.6,
                         w=240 / n, h=120 / n, opacity=0.9)
                    for s in range(n * n)]


def fractional_horizontal():
    return C, [_cam((192, 64), C, 30, x=20.3, y=30.7, w=128, h=64,
                    opacity=0.9)]


def fractional_vertical():
    return C, [_cam((128, 96), C, 31, x=10.3, y=10.6, w=128, h=64)]


def mixed_vertical_scales():
    return C, [_cam(C, C, 40, x=0, y=0, w=256, h=128),
               _cam(C, C, 41, x=120.3, y=30.7, w=128, h=64,
                    opacity=0.85)]


def mixed_scale_classes():
    return C, [_cam(C, C, 42, x=0, y=0, w=256, h=128),
               _cam(C, C, 43, x=20.4, y=10.7, w=128, h=64),
               _cam(C, C, 44, x=150.2, y=70.6, w=256 / 3, h=128 / 3)]


def three_scale_classes():
    return C, [_cam(C, C, 45, x=0.25, y=0.25, w=128, h=64),
               _cam(C, C, 46, x=150.2, y=70.6, w=256 / 3, h=128 / 3),
               _cam(C, C, 47, x=60.7, y=80.3, w=64, h=32)]


def clamped_box_overlay():
    return C, [_cam(C, C, 50, x=0, y=0, w=256, h=128),
               _cam(C, C, 51, x=166.5, y=10.3, w=128, h=72, opacity=0.9)]


def narrow_overlay():
    return C, [_cam(C, C, 52, x=0, y=0, w=256, h=128),
               _cam((40, 24), C, 53, x=120.3, y=60.7, w=20, h=12,
                    opacity=0.9)]


def mixed_sizes():
    return C, [_cam(C, C, 60, x=0, y=0, w=256, h=128),
               _cam((128, 64), C, 61, x=40.3, y=20.7, w=128, h=64,
                    opacity=0.85),
               _cam((128, 64), C, 62, x=150.5, y=60.1, w=64, h=32,
                    opacity=0.7, fill_color=(0.2, 0.4, 0.1, 0.5))]


def rgba_overlay(fmt=RGBA):
    return C, [_cam(C, C, 70, x=0, y=0, w=256, h=128),
               _label((96, 48), C, 71, fmt, x=40.3, y=30.7, w=96, h=48,
                      opacity=0.9, fill_color=(0.2, 0.1, 0.5, 0.4))]


def edge_cases():
    return C, [_cam(C, C, 80, x=0, y=0, w=256, h=128),
               _cam(C, C, 81, x=40.3, y=20.7, w=128, h=64, opacity=0.0),
               _cam(C, C, 82, x=700.0, y=20.0, w=128, h=64, opacity=0.9),
               _cam(C, C, 83, x=256 - 128 - 0.7, y=128 - 64 - 0.3, w=128,
                    h=64, opacity=0.8)]


def interleaved_labels():
    srcs = []
    for s in range(3):
        x, y = (s % 2) * 128, (s // 2) * 64
        srcs.append(_cam(C, C, 90 + s, x=x + 0.4, y=y + 0.3, w=128, h=64))
        srcs.append(_label((64, 16), C, 95 + s, x=x + 10.3, y=y + 40.7,
                           w=64, h=16, opacity=0.8))
    return C, srcs


def overlap_order():
    return C, [_cam(C, C, 100, x=0.4, y=0.3, w=128, h=64),
               _label((192, 24), C, 101, x=40.3, y=40.7, w=192, h=24,
                      opacity=0.7),
               _cam(C, C, 102, x=128.4, y=0.3, w=128, h=64)]


def rotated_overlay():
    return C, [_cam(C, C, 110, x=0, y=0, w=256, h=128),
               _cam((128, 64), C, 111, x=60.3, y=30.7, w=128, h=64,
                    opacity=0.9, rotation=0.3)]


def convert_out():
    src = (256, 144)
    return (128, 72), [(_planes(144, 256, 120), Y420P,
                        identity_uniforms(src, (128, 72)))]


def convert_out_placed():
    return (128, 72), [_cam((192, 128), (128, 72), 121, x=20.3, y=10.7,
                            w=96, h=64, opacity=0.85,
                            fill_color=(0.3, 0.1, 0.6, 0.4))]


SCENES = [
    ("unity_copy", Y420P, unity_copy),
    ("unity_overlap", Y420P, unity_overlap),
    ("quadrants_2to1", Y420P, quadrants_2to1),
    ("multiview_3x3", Y420P, lambda: multiview(3)),
    ("multiview_4x4", Y420P, lambda: multiview(4)),
    ("fractional_horizontal", Y420P, fractional_horizontal),
    ("fractional_vertical", Y420P, fractional_vertical),
    ("mixed_vertical_scales", Y420P, mixed_vertical_scales),
    ("mixed_scale_classes", Y420P, mixed_scale_classes),
    ("three_scale_classes", Y420P, three_scale_classes),
    ("clamped_box_overlay", Y420P, clamped_box_overlay),
    ("narrow_overlay", Y420P, narrow_overlay),
    ("mixed_sizes", Y420P, mixed_sizes),
    ("rgba_overlay", Y420P, rgba_overlay),
    ("bgra_overlay", Y420P, lambda: rgba_overlay(BGRA)),
    ("edge_cases", Y420P, edge_cases),
    ("interleaved_labels", Y420P, interleaved_labels),
    ("overlap_order", Y420P, overlap_order),
    ("rotated_overlay", Y420P, rotated_overlay),
    ("quadrants_nv12", NV12, quadrants_2to1),
    ("quadrants_nv21", NV21, quadrants_2to1),
    ("rgba_overlay_nv12", NV12, rgba_overlay),
    ("rotated_overlay_nv12", NV12, rotated_overlay),
    ("convert_rgba", RGBA, convert_out),
    ("convert_bgra_placed", BGRA, convert_out_placed),
]

PROGRAMS = {
    "tick": composite.composite_tick,
    "device": composite.composite_stack_device,
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("name,out_fmt,scene", SCENES,
                         ids=[s[0] for s in SCENES])
def test_tick_program_matches_oracle(name, out_fmt, scene, program):
    size, srcs = scene()
    ref = golden.composite_stack(out_fmt, size, srcs)
    out = PROGRAMS[program](out_fmt, size, srcs)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        o, r = np.asarray(o), np.asarray(r)
        assert o.shape == r.shape
        err = np.abs(o.astype(int) - r.astype(int))
        assert err.max() <= 1, (name, int(err.max()), int((err > 1).sum()))
