"""VideoMixer: clock-driven composited frame source.

Reference semantics: ``/root/reference/Sources/SwiftVideo/mix.video.swift``.

Every ``frame_duration`` tick the mixer merges **two generations** of
per-revision sample maps (fresh frames win; the previous generation repeats
a source's last frame when no new one arrived — mix.video.swift:105-114),
z-sorts them, and composites into the output.

Device deviations:

* The per-source kernel-launch fold (clear, then one ``applyComputeImage``
  per source with a ``clFinish`` sync — mix.video.swift:116-125) becomes
  **one fused jitted program per tick** (ops.composite's boxed folds) —
  a single XLA dispatch for clear + N sources, with no per-frame sync.
* The 10-image GPU backing ring (mix.video.swift:148-167) is unnecessary:
  XLA owns device buffers and the program output is a fresh immutable
  array; pipelining comes from async dispatch, not from a ring.  pts comes
  from the clock tick, never from device completion, so N-deep pipelining
  never perturbs timestamps.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import (Clock, ClockTickEvent, EventBox, Source, StatsReport,
                    TimePoint, rescale)
from ..media.picture import BufferType, ImageBuffer, PictureSample
from ..media.pixel import PixelFormat, planes_for_format
from ..ops import ImageUniforms, composite, golden
from ..ops.registry import ComputeContext, make_compute_context


class VideoMixer(Source):
    def __init__(self, clock: Clock, *, workspace_id: str,
                 frame_duration: TimePoint, output_size: Tuple[int, int],
                 output_format: PixelFormat = PixelFormat.nv12,
                 compute_context: Optional[ComputeContext] = None,
                 asset_id: Optional[str] = None,
                 stats_report: Optional[StatsReport] = None,
                 epoch: Optional[int] = None):
        super().__init__()
        self.clock = clock
        self.frame_duration = frame_duration
        self.output_size = tuple(output_size)
        self.output_format = output_format
        self.ctx = compute_context or make_compute_context()
        self.id_workspace = workspace_id
        self.id_asset = asset_id or str(uuid.uuid4())
        self.stats = stats_report or StatsReport(asset_id=self.id_asset,
                                                 clock=clock)
        now = clock.current()
        epoch_tp = (clock.from_unix_time(epoch) if epoch is not None else now)
        self.epoch = rescale(epoch_tp, frame_duration.scale)
        # two generations of per-revision sample maps (mix.video.swift:44)
        self._samples: List[Dict[str, PictureSample]] = [{}, {}]
        self._lock = threading.RLock()
        self._closed = False

        def digest(pic: PictureSample) -> EventBox:
            if pic.asset_id() != self.id_asset:
                with self._lock:
                    self._samples[0][pic.revision()] = pic
                return EventBox.nothing(pic.info())
            return EventBox.just(pic)

        self.set(digest)
        clock.schedule(now + frame_duration, self._mix)

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def compute_context(self) -> ComputeContext:
        return self.ctx

    def close(self) -> None:
        self._closed = True
        self.stats.close()

    # --- tick (mix.video.swift:95-131) -----------------------------------
    def _mix(self, at: ClockTickEvent) -> None:
        if self._closed:
            return
        pts = at.time() - self.epoch
        self.clock.schedule(at.time() + self.frame_duration, self._mix)
        self.stats.end_timer("mix.video.delta")
        self.stats.start_timer("mix.video.delta")
        self.stats.start_timer("mix.video.compose")
        with self._lock:
            merged = dict(self._samples[1])
            merged.update(self._samples[0])  # fresh generation wins
            self._samples[1] = self._samples[0]
            self._samples[0] = {}
        images = sorted(merged.values(), key=lambda s: s.z_index())
        try:
            sources = []
            for img in images:
                try:
                    uni = ImageUniforms(
                        transform_inv=np.linalg.inv(
                            img.matrix().astype(np.float64)).astype(np.float32),
                        texture_inv=np.linalg.inv(
                            img.texture_matrix().astype(np.float64)).astype(np.float32),
                        border_inv=np.linalg.inv(
                            img.border_matrix().astype(np.float64)).astype(np.float32),
                        fill_color=np.asarray(img.fill_color(), np.float32),
                        input_size=img.size(), output_size=self.output_size,
                        opacity=img.opacity())
                except np.linalg.LinAlgError:
                    # degenerate transform (zero-size element): skip the
                    # source, keep the frame
                    continue
                sources.append((list(img.planes()), img.pixel_format(), uni))
            if self.ctx.backend == "golden":
                planes = golden.composite_stack(self.output_format,
                                                self.output_size, sources)
                btype = BufferType.cpu
            else:
                planes = composite.composite_tick(
                    self.output_format, self.output_size, sources)
                btype = BufferType.gpu
            self.stats.end_timer("mix.video.compose")
            img = ImageBuffer(
                pixel_format=self.output_format, buffer_type=btype,
                size=self.output_size,
                planes=tuple(planes_for_format(self.output_format,
                                               self.output_size)),
                buffers=tuple(planes))
            sample = PictureSample(
                img, self.id_asset, self.id_workspace,
                time_point=at.time(), pts_value=pts,
                event_info=self.stats)
            self.emit(sample)
        except Exception as exc:  # mix errors must not kill the clock loop
            self.stats.end_timer("mix.video.compose")
            import traceback
            traceback.print_exc()
