"""64-stream mixing wall on a device mesh: JAX's default devices, or a
virtual n-device CPU mesh with SV_DEVICE=cpu.

Run: python examples/wall_demo.py [n_devices]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n_devices: int = 8) -> None:
    if os.environ.get("SV_DEVICE") == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{n_devices}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from swiftvideo_tpu.parallel import MixingWall, make_mesh

    mesh = make_mesh(jax.devices()[:n_devices])
    wall = MixingWall(mesh, n_streams=64, stream_size=(96, 54),
                      canvas_size=(256, 128), audio_samples=48)
    rng = np.random.default_rng(0)
    ys = wall.shard(jnp.asarray(rng.integers(0, 256, (64, 54, 96),
                                             np.int64).astype(np.uint8)))
    us = wall.shard(jnp.full((64, 27, 48), 128, jnp.uint8))
    vs = wall.shard(jnp.full((64, 27, 48), 128, jnp.uint8))
    audio = wall.shard(jnp.full((64, 96), 25, jnp.int16))
    wy, wu, wv, mixed = wall.step(ys, us, vs, audio)
    print("wall:", wy.shape, "sharding:", wy.sharding)
    print("mixed audio head:", np.asarray(mixed)[:4], "(expect 25*64=1600)")
    import cv2
    from swiftvideo_tpu.media import PixelFormat
    from swiftvideo_tpu.ops import golden, identity_uniforms
    rgba = golden.composite_stack(
        PixelFormat.RGBA, (wy.shape[1], wy.shape[0]),
        [([np.asarray(wy), np.asarray(wu), np.asarray(wv)],
          PixelFormat.y420p,
          identity_uniforms((wy.shape[1], wy.shape[0]),
                            (wy.shape[1], wy.shape[0])))])[0]
    out = "/tmp/wall_demo.png"
    cv2.imwrite(out, rgba[..., [2, 1, 0, 3]])
    print("wrote", out)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
