"""Mixing example: multiple synthetic sources composited by a Composer.

Role parity with /root/reference/Examples/Mixing/main.swift: sources feed a
picture bus, a Composer binds them to scene elements, the VideoMixer emits
composited frames — dumped as PNGs here instead of RTMP-publishing.

Run: python examples/mixing_demo.py [out_dir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("SV_DEVICE") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from swiftvideo_tpu.compose import Composer, Composition, Element, ElementState, Scene
from swiftvideo_tpu.core import Bus, EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu.media import PixelFormat, create_picture_sample
from swiftvideo_tpu.ops import make_compute_context


def synthetic_source(name: str, size, pattern: int):
    s = create_picture_sample(size, PixelFormat.y420p, asset_id=name,
                              workspace_id="demo")
    y, x = np.mgrid[0:size[1], 0:size[0]]
    s.planes()[0][:] = ((x * (pattern + 1) + y) % 256).astype(np.uint8)
    s.planes()[1][:] = 128 + pattern * 30
    s.planes()[2][:] = 128 - pattern * 30
    return s


def main(out_dir: str = "/tmp/mixing_demo") -> None:
    os.makedirs(out_dir, exist_ok=True)
    clock = StepClock(TimePoint(480, 48000))  # 10 ms steps
    audio_bus = Bus(clock)
    picture_bus = Bus(clock)
    comp = Composition(
        name="demo", canvas_size=(640, 360),
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000),
        scenes=(Scene(name="main", elements=(
            Element(name="background", initial_state=ElementState(
                pic_pos=(0, 0), size=(640, 360))),
            Element(name="pip", initial_state=ElementState(
                pic_pos=(400, 20), size=(220, 124)), z_index=1),
        )),),
        initial_scene="main")
    composer = Composer(clock, workspace_id="demo", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=make_compute_context())
    frames = []
    sub = picture_bus.subscribe(Tx(
        lambda s: (frames.append(s), EventBox.just(s))[1]
        if s.asset_id() == "demo" else EventBox.nothing(None)))
    composer.bind("camA", "background")
    composer.bind("camB", "pip")
    picture_bus.append(EventBox.just(synthetic_source("camA", (320, 180), 0)))
    picture_bus.append(EventBox.just(synthetic_source("camB", (160, 90), 2)))
    for _ in range(40):
        clock.step()
    composer.close()
    mixed = [f for f in frames if f.asset_id() == "demo"]
    print(f"mixed {len(mixed)} frames")
    if mixed:
        import cv2
        from swiftvideo_tpu.ops import golden, identity_uniforms
        last = mixed[-1]
        planes = [np.asarray(p) for p in last.planes()]
        rgba = golden.composite_stack(
            PixelFormat.RGBA, last.size(),
            [(planes, PixelFormat.y420p,
              identity_uniforms(last.size(), last.size()))])[0]
        path = os.path.join(out_dir, "frame.png")
        cv2.imwrite(path, rgba[..., [2, 1, 0, 3]])
        print("wrote", path, rgba.shape)


if __name__ == "__main__":
    main(*sys.argv[1:2])
