"""Host<->device transfer barriers as graph stages.

Reference semantics: ``GPUBarrierUpload`` / ``GPUBarrierDownload``
(compute.swift:175-255) with ``gpu.upload`` / ``gpu.download`` timers, plus
the audio barrier pair the reference left dormant (compute.swift:200-282) —
implemented here for the device audio mixing path.

Device transfers: uploads are ``jax.device_put`` of dense planes (asynchronous;
no per-plane blocking writes — the reference's blocking clEnqueueWriteImage
is exactly what to avoid, SURVEY.md §7), downloads materialize numpy arrays.
"""

from __future__ import annotations

import jax
import numpy as np

from ..core import EventBox, Tx
from ..media.audio import AudioSample
from ..media.picture import BufferType, PictureSample
from .registry import ComputeContext


class GPUBarrierUpload(Tx):
    """Move PictureSample planes to device memory (compute.swift:175-198)."""

    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: PictureSample) -> EventBox:
        if sample.buffer_type() == BufferType.gpu or self._ctx.backend == "golden":
            return EventBox.just(sample)
        info = sample.info()
        if info is not None:
            info.start_timer("gpu.upload")
        device = self._ctx.device
        buffers = tuple(jax.device_put(np.asarray(p), device)
                        for p in sample.planes())
        img = sample.img.with_buffers(buffers, BufferType.gpu)
        if info is not None:
            info.end_timer("gpu.upload")
        return EventBox.just(sample.with_(img=img))


class GPUBarrierDownload(Tx):
    """Materialize device planes back to host (compute.swift:230-255)."""

    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: PictureSample) -> EventBox:
        if sample.buffer_type() == BufferType.cpu:
            return EventBox.just(sample)
        info = sample.info()
        if info is not None:
            info.start_timer("gpu.download")
        buffers = tuple(np.asarray(p) for p in sample.planes())
        img = sample.img.with_buffers(buffers, BufferType.cpu)
        if info is not None:
            info.end_timer("gpu.download")
        return EventBox.just(sample.with_(img=img))


class GPUBarrierAudioUpload(Tx):
    """Audio device upload (the reference's dormant audio barrier,
    compute.swift:200-227, made functional)."""

    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: AudioSample) -> EventBox:
        if sample.compute_buffers is not None or self._ctx.backend == "golden":
            return EventBox.just(sample)
        buffers = tuple(jax.device_put(np.asarray(b), self._ctx.device)
                        for b in sample.buffers)
        return EventBox.just(sample.with_(compute_buffers=buffers))


class GPUBarrierAudioDownload(Tx):
    def __init__(self, ctx: ComputeContext):
        self._ctx = ctx
        super().__init__(self._impl)

    def _impl(self, sample: AudioSample) -> EventBox:
        if sample.compute_buffers is None:
            return EventBox.just(sample)
        buffers = tuple(np.asarray(b) for b in sample.compute_buffers)
        return EventBox.just(sample.with_(buffers=buffers, compute_buffers=None))
