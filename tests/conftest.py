"""Test configuration.

Tests run on the CPU with a virtual 8-device mesh, so multi-device
sharding paths compile and execute without accelerators.  JAX_PLATFORMS
decides: unset, it is pinned to ``cpu`` here; set to another platform
(``JAX_PLATFORMS=cuda`` on a GPU host), it is left alone so the tests
marked ``gpu`` run on the card.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Build the native shims on a fresh checkout (the .so files are
# gitignored).  Failures are non-fatal: every native path has a tested
# Python fallback and the libav suite skips itself when the shim is
# absent — this hook just keeps that coverage ON wherever a compiler
# and the system libav exist.
_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
if not all(os.path.exists(os.path.join(_CSRC, so))
           for so in ("libsvbitstream.so", "libsvrtmp.so", "libsvav.so")):
    import subprocess
    try:
        subprocess.run(["make", "-C", _CSRC], timeout=120,
                       capture_output=True, check=False)
    except Exception:  # noqa: BLE001
        pass


@pytest.fixture
def gpu():
    """The tests marked ``gpu`` need an NVIDIA GPU as JAX's default
    device; decided here, at run time, never at import."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on a GPU host")
    return jax.devices()[0]


@pytest.fixture
def mesh8():
    """An 8-device mesh (the virtual CPU devices configured above)."""
    import jax

    from swiftvideo_tpu.parallel import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip(f"needs 8 devices, JAX sees {len(jax.devices())}")
    return make_mesh(jax.devices()[:8])
