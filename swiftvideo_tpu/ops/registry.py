"""Compute front-end: kernel naming, context, and the run/apply entry points.

Reference semantics: ``/root/reference/Sources/SwiftVideo/compute.swift``
(ComputeKernel enum :49-74, kernel-name map :90-110, makeComputeContext :121,
applyComputeImage :145-170).

Kernels keep the reference's ``img_<inFmt>_<outFmt>`` naming; the registry
resolves a name to the fused device program (ops.composite).  The
coverage is the full cross product of {y420p, nv12, nv21, rgba, bgra} inputs
x {y420p, nv12, rgba, bgra} outputs — a superset of the reference's
per-backend kernel matrix (SURVEY.md §2.3), because here every pair shares
one generic spec implementation.  ``custom`` kernels are user-registered
callables (compute.swift .custom case).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from ..media.pixel import BufferType, PixelFormat
from ..media.picture import PictureSample
from . import composite, golden
from .uniforms import ImageUniforms

_FMT_NAMES = {
    PixelFormat.y420p: "y420p", PixelFormat.nv12: "nv12",
    PixelFormat.nv21: "nv21", PixelFormat.RGBA: "rgba",
    PixelFormat.BGRA: "bgra", PixelFormat.y422p: "y422p",
    PixelFormat.y444p: "y444p",
}
_NAME_FMTS = {v: k for k, v in _FMT_NAMES.items()}


class ComputeError(Exception):
    pass


@dataclass(frozen=True)
class ComputeKernel:
    """A kernel identity: composite conversion, clear, audio, motion, or
    custom (compute.swift:49-74)."""

    name: str

    @staticmethod
    def composite(in_fmt: PixelFormat, out_fmt: PixelFormat) -> "ComputeKernel":
        return ComputeKernel(f"img_{_FMT_NAMES[in_fmt]}_{_FMT_NAMES[out_fmt]}")

    @staticmethod
    def clear(fmt: PixelFormat) -> "ComputeKernel":
        return ComputeKernel(f"img_clear_{_FMT_NAMES[fmt]}")

    @staticmethod
    def custom(name: str) -> "ComputeKernel":
        return ComputeKernel(name)


def default_compute_kernel_from_string(name: str) -> ComputeKernel:
    """Kernel-name lookup (compute.swift:90-110).  img_clear_rgba aliases
    img_clear_bgra like the reference; composite names must parse to known
    formats."""
    if name == "img_clear_rgba":
        name = "img_clear_bgra"
    parts = name.split("_")
    if len(parts) == 3 and parts[0] == "img":
        if parts[1] == "clear":
            if parts[2] not in _NAME_FMTS:
                raise ComputeError(f"invalid kernel {name}")
        elif parts[1] not in _NAME_FMTS or parts[2] not in _NAME_FMTS:
            raise ComputeError(f"invalid kernel {name}")
        return ComputeKernel(name)
    if name in ("snd_s16i_s16i", "me_fullsearch", "me_fullsearch_ssd",
                "me_fullsearch_pyramid"):
        return ComputeKernel(name)
    raise ComputeError(f"invalid kernel {name}")


@dataclass
class ComputeContext:
    """Device context: caches jitted programs, tracks custom kernels, and
    selects the execution backend (makeComputeContext, compute.swift:121).

    backend: 'jax' (the jitted XLA device path) or 'golden' (numpy
    oracle, debugging).
    """

    backend: str = "jax"
    device: Optional[object] = None
    logger: Optional[object] = None
    custom_kernels: Dict[str, Callable] = field(default_factory=dict)
    ident: str = field(default_factory=lambda: str(uuid.uuid4()))

    def register_kernel(self, name: str, fn: Callable) -> None:
        self.custom_kernels[name] = fn


def has_available_compute_devices() -> bool:
    try:
        import jax
        return len(jax.devices()) > 0
    except Exception:
        return False


def make_compute_context(backend: str = "jax") -> ComputeContext:
    if backend == "jax":
        import jax
        devices = jax.devices()
        if not devices:
            raise ComputeError("deviceNotAvailable")
        return ComputeContext(backend=backend, device=devices[0])
    if backend == "golden":
        return ComputeContext(backend="golden", device=None)
    raise ComputeError(f"unknown compute backend {backend!r}")


def begin_compute_pass(ctx: ComputeContext) -> ComputeContext:
    return ctx


def end_compute_pass(ctx: ComputeContext, wait: bool = False) -> ComputeContext:
    """endComputePass (compute.cl.swift:346-359).  The XLA analogue of
    clFinish is block_until_ready on outstanding outputs; dispatch is async
    by default, so this is a no-op unless the caller holds arrays."""
    return ctx


def using_context(ctx: ComputeContext, fn) -> ComputeContext:
    return end_compute_pass(fn(begin_compute_pass(ctx)), True)


# --- kernel execution -----------------------------------------------------

def run_compute_kernel(ctx: ComputeContext, images, target: PictureSample,
                       kernel: ComputeKernel, uniforms=None,
                       blends: bool = True) -> PictureSample:
    """Run one named kernel (compute.cl.swift:264-344 equivalent).

    Composite kernels read ``images[0]`` + the current target planes and
    return a new target sample; clear kernels reset the target.
    """
    name = kernel.name
    if name in ctx.custom_kernels:
        return ctx.custom_kernels[name](ctx, images, target, uniforms)
    parts = name.split("_")
    if parts[0] == "img" and parts[1] == "clear":
        fmt = target.pixel_format()
        if ctx.backend == "golden":
            planes = golden.clear_planes(fmt, target.size())
        else:
            planes = composite.clear_device(fmt, target.size())
        return target.with_(img=target.img.with_buffers(planes))
    if name in ("me_fullsearch", "me_fullsearch_ssd",
                "me_fullsearch_pyramid"):
        # motion estimation: images = [current, reference] luma samples;
        # emits an RGBA MV map at block resolution (kernels.metal:206-267).
        # The _ssd variant runs the matmul formulation (documented metric
        # deviation, ops/motion.py module notes) — the production speed
        # mode; _pyramid is the experimental two-stage mode (stride-2
        # coarse grid + exact local refine).
        from ..media.picture import ImageBuffer
        from ..media.pixel import planes_for_format
        from . import motion
        if len(images) < 2:
            raise ComputeError("badInputData")
        cur, ref = images[0], images[1]
        if name.endswith("_pyramid"):
            mv = motion.me_fullsearch_pyramid(cur.planes()[0],
                                              ref.planes()[0])
        else:
            mv = motion.me_fullsearch_device(
                cur.planes()[0], ref.planes()[0],
                metric="ssd" if name.endswith("_ssd") else "sad")
        h, w = mv.shape[:2]
        img = ImageBuffer(pixel_format=PixelFormat.RGBA,
                          buffer_type=BufferType.gpu, size=(w, h),
                          planes=tuple(planes_for_format(PixelFormat.RGBA,
                                                         (w, h))),
                          buffers=(mv,))
        return target.with_(img=img)
    if name == "snd_s16i_s16i":
        raise ComputeError("snd_s16i_s16i runs via ops.audio.mix_s16_device")
    if parts[0] == "img":
        if not images:
            raise ComputeError("badInputData")
        image = images[0]
        in_fmt = _NAME_FMTS[parts[1]]
        out_fmt = _NAME_FMTS[parts[2]]
        if image.pixel_format() != in_fmt or target.pixel_format() != out_fmt:
            raise ComputeError(
                f"kernel {name} vs formats {image.pixel_format()}/{target.pixel_format()}")
        uni = uniforms if uniforms is not None else \
            ImageUniforms.from_sample(image, target)
        if ctx.backend == "golden":
            planes = golden.apply_composite(
                [np.asarray(p) for p in target.planes()], out_fmt,
                [np.asarray(p) for p in image.planes()], in_fmt, uni)
        else:
            planes = composite.apply_composite_device(
                target.planes(), out_fmt, image.planes(), in_fmt, uni)
        return target.with_(img=target.img.with_buffers(planes))
    raise ComputeError(f"computeKernelNotFound: {name}")


def apply_compute_image(ctx: ComputeContext, image: PictureSample,
                        target: PictureSample,
                        kernel: Optional[ComputeKernel] = None) -> PictureSample:
    """Composite ``image`` over ``target`` with the sample's own matrices
    (applyComputeImage, compute.swift:145-170)."""
    if kernel is None:
        kernel = ComputeKernel.composite(image.pixel_format(),
                                         target.pixel_format())
    uni = ImageUniforms.from_sample(image, target)
    return run_compute_kernel(ctx, [image], target, kernel, uni, blends=True)
