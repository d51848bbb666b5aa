"""Multiview wall example: a 3x3 grid of sources composited by the
mixer's tick program (``composite.composite_tick``, one jitted XLA fold
per frame).

Role parity with a production multiview monitor: nine cameras tiled onto
one 1080p program output, plus an RGBA label strip over each tile.

Run: python examples/multiview_demo.py [out_dir]
(on JAX's default device; SV_DEVICE=cpu forces the CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("SV_DEVICE") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from swiftvideo_tpu.media.pixel import PixelFormat
from swiftvideo_tpu.ops import composite, golden, rect_uniforms


def camera(seed: int, w: int, h: int):
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return [((x * (seed + 1) // 8 + y // 4) % 200 + 28).astype(np.uint8),
            np.full((h // 2, w // 2), 128 + (seed % 5) * 18, np.uint8),
            np.full((h // 2, w // 2), 128 - (seed % 7) * 12, np.uint8)]


def label(seed: int, w: int, h: int):
    """A tinted translucent strip standing in for a TextRenderer label."""
    a = np.zeros((h, w, 4), np.uint8)
    a[..., seed % 3] = 230
    a[..., 3] = 200
    return [a]


def main(out_dir: str = "/tmp/multiview_demo") -> None:
    os.makedirs(out_dir, exist_ok=True)
    W, H = 1920, 1080
    tw, th = W // 3, H // 3
    srcs = []
    for s in range(9):
        x, y = (s % 3) * tw, (s // 3) * th
        srcs.append((camera(s, W, H), PixelFormat.y420p,
                     rect_uniforms((W, H), (W, H), x=x + 0.4, y=y + 0.3,
                                   w=tw, h=th, opacity=1.0).pack()))
        srcs.append((label(s, tw, 32), PixelFormat.RGBA,
                     rect_uniforms((tw, 32), (W, H), x=x + 8.3,
                                   y=y + th - 40.7, w=tw - 16, h=32,
                                   opacity=0.85).pack()))
    import jax
    out = composite.composite_tick(PixelFormat.y420p, (W, H), srcs)
    planes = [np.asarray(p) for p in out]
    print("composited 3x3 wall:", [p.shape for p in planes],
          "on", jax.devices()[0].platform)
    try:
        import cv2
        from swiftvideo_tpu.ops import identity_uniforms
        rgba = golden.composite_stack(
            PixelFormat.RGBA, (W, H),
            [(planes, PixelFormat.y420p,
              identity_uniforms((W, H), (W, H)))])[0]
        path = os.path.join(out_dir, "wall.png")
        cv2.imwrite(path, rgba[..., [2, 1, 0, 3]])
        print("wrote", path)
    except Exception as exc:  # noqa: BLE001 - png dump is optional
        print("png dump skipped:", exc)


if __name__ == "__main__":
    main(*sys.argv[1:2])
