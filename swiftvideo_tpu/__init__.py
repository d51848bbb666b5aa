"""swiftvideo_tpu — a JAX live video streaming and processing framework.

A ground-up rebuild of the capabilities of unpause-live/SwiftVideo on JAX,
run on NVIDIA GPUs: RTMP / flavor network protocols feed coded media into
decode -> mix/composite -> encode -> publish pipelines glued together by a
functional reactive graph driven by rational-time clocks.  The media compute
slice (colorspace conversion, scaling, alpha-composite, audio mixing,
resampling, motion estimation) runs as jitted XLA programs over dense frame
tensors, sharded across devices with jax.sharding for multi-stream walls;
protocol and codec glue stays host-side.

Layer map (mirrors reference SURVEY.md §1):
  core/     — TimePoint, clocks, EventBox/Tx/Bus graph algebra, StatsReport
  media/    — PictureSample / AudioSample / CodedMediaSample value types
  ops/      — device compute: kernel registry, golden CPU oracle, jitted
              XLA programs (composite, audio mix, resampler, motion)
  mix/      — VideoMixer, AudioMixer, animators, segmenter, repeater
  compose/  — Composer + scene-graph manifests
  net/      — asyncio TCP, RTMP (AMF0, chunking, handshake), flavor protocol
  codec/    — bitstream parsers (C++ shim), gated FFmpeg codec glue
  parallel/ — device-mesh sharding for multi-GPU mixing walls
"""

__version__ = "0.1.0"
