"""Rotating-element example: an animated rotation transition through the
Composer, exercising PictureAnimator's rotation lerp and the mixer's
gather-free warp path (ops/warp.py).

Role parity: the reference animates element transforms through
`PictureAnimator` (animator.pic.swift:193-205 lerps rotation) and its GPU
samplers take any 4x4 transform; here large rotated sources route
through the three-pass shear warp (one angle-stable compiled program for
the whole animation).

Run: python examples/rotation_demo.py [out_dir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("SV_DEVICE") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from swiftvideo_tpu.compose import (Composer, Composition, Element,
                                    ElementState, Scene)
from swiftvideo_tpu.core import Bus, EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu.media import PixelFormat, create_picture_sample
from swiftvideo_tpu.ops import make_compute_context


def smooth_source(name: str, size):
    s = create_picture_sample(size, PixelFormat.y420p, asset_id=name,
                              workspace_id="demo")
    y, x = np.mgrid[0:size[1], 0:size[0]]
    s.planes()[0][:] = np.clip(127 + 90 * np.sin(x / 23.0)
                               * np.cos(y / 17.0), 0, 255).astype(np.uint8)
    s.planes()[1][:] = 96
    s.planes()[2][:] = 170
    return s


def main(out_dir: str = "/tmp/rotation_demo") -> None:
    os.makedirs(out_dir, exist_ok=True)
    clock = StepClock(TimePoint(480, 48000))
    audio_bus = Bus(clock)
    picture_bus = Bus(clock)
    comp = Composition(
        name="demo", canvas_size=(640, 360),
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000),
        scenes=(Scene(name="main", elements=(
            Element(name="card", initial_state=ElementState(
                pic_pos=(160, 90), size=(320, 180), rotation=0.0)),
        )),),
        initial_scene="main")
    composer = Composer(clock, workspace_id="demo", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=make_compute_context())
    frames = []
    sub = picture_bus.subscribe(Tx(   # noqa: F841 (weak emit chain)
        lambda s: (frames.append(s), EventBox.just(s))[1]
        if s.asset_id() == "demo" else EventBox.nothing(None)))
    composer.bind("card-src", "card")
    picture_bus.append(EventBox.just(smooth_source("card-src", (320, 180))))
    # animate a half-second spin to 35 degrees
    composer.set_state("card", ElementState(
        pic_pos=(160, 90), size=(320, 180), rotation=0.6),
        duration=TimePoint(24000, 48000))
    for _ in range(60):
        clock.step()
    composer.close()
    mixed = [f for f in frames if f.asset_id() == "demo"]
    print(f"mixed {len(mixed)} frames (rotation animated)")
    if mixed:
        import cv2

        from swiftvideo_tpu.ops import golden, identity_uniforms
        for tag, f in (("first", mixed[0]), ("last", mixed[-1])):
            planes = [np.asarray(p) for p in f.planes()]
            rgba = golden.composite_stack(
                PixelFormat.RGBA, f.size(),
                [(planes, PixelFormat.y420p,
                  identity_uniforms(f.size(), f.size()))])[0]
            path = os.path.join(out_dir, f"{tag}.png")
            cv2.imwrite(path, rgba[..., [2, 1, 0, 3]])
            print("wrote", path)


if __name__ == "__main__":
    main(*sys.argv[1:2])
