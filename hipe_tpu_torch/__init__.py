"""hipe_tpu_torch — the PyTorch/CUDA port of hipe_tpu for NVIDIA Hopper.

A second package beside :mod:`hipe_tpu` (the JAX reference, which stays as
it is). It mirrors that package's layout so each module's counterpart is
easy to find:

- :mod:`hipe_tpu_torch.ops.blur` — the plain PyTorch integer filters
  (``FILTERS``, ``filter_chain``, ``register_lut_filter``,
  ``register_rank_filter``, ``register_kernel_filter``);
- :mod:`hipe_tpu_torch.ops.cuda_blur` — the hand-written CUDA stencil K1
  (``csrc/blur_planar.cu``) that replaces the Pallas blur kernels, planar
  and interleaved-rows entries;
- :mod:`hipe_tpu_torch.ops.cuda_chain` — the hand-written fused chain
  kernel K2 (``csrc/chain_planar.cu``) that replaces the Pallas band chain,
  planar and interleaved-rows entries;
- :mod:`hipe_tpu_torch.ops.cuda_rank_chain` — the hand-written fused chain
  kernel K3 (``csrc/rank_chain_planar.cu``) that replaces the Pallas chain
  of rank, nonlinear and registered-kernel stages;
- :mod:`hipe_tpu_torch.ops.cuda_tiled` — the hand-written 2-D-tiled kernels
  K4 (``csrc/tiled_blur_planar.cu``) and K5 (``csrc/tiled_stage_planar.cu``)
  that replace the Pallas halo-tiled kernels for large frames;
- :mod:`hipe_tpu_torch.ops.planar` — ``filter_planar``, the one choice among
  K1-K5 of a planar chain; every kernel launches through ``ops/_build.py``'s
  ``entry``;
- :mod:`hipe_tpu_torch.ops.cuda_dct` — the hand-written DCT kernels K6
  (dequantize + IDCT) and K7 (fDCT + quantize) of the device JPEG codec
  (``csrc/dct_blocks.cu``), which replace the Pallas DCT kernels;
- :mod:`hipe_tpu_torch.ops.jpeg_decode`, :mod:`hipe_tpu_torch.ops.jpeg_encode`
  — the device codec (``decode_coefficients``, ``decode_planes``,
  ``decode_planes_scaled``, ``encode_planes``, ``encode_bytes_device``);
  :mod:`hipe_tpu_torch.io_.jpeg` — its host entropy layer, the libjpeg codec
  (``csrc/jpeg_codec.cpp``); :mod:`hipe_tpu_torch.ops.jpeg_transform` — the
  lossless DCT-domain transforms; :mod:`hipe_tpu_torch.ops.resize` — the Q14
  bilinear resize; :mod:`hipe_tpu_torch.ops.equalize` — the
  global-statistics ops (equalize, autocontrast, contrast, color,
  sharpness, mode) and ``colorize_lut``;
- :mod:`hipe_tpu_torch.models.pipelines` — ``Pipeline``/``PIPELINES``
  (``apply_planar``, ``apply_rows``, ``apply_nhwc``) and
  ``GlobalStatsPipeline``;
- :mod:`hipe_tpu_torch.runtime.device_stream` — ``DeviceStreamRunner``,
  the device-resident stream (5000 images of 256x256, or large frames);
- :mod:`hipe_tpu_torch.runtime.serve` — ``ServingPipeline``, JPEG decode ->
  filter -> encode in four placements of the codec, with ``hipe_tpu``'s
  scaled/gray decode, resize, thumbnail, gray and colorize options;
- :mod:`hipe_tpu_torch.runtime.engine`, :mod:`hipe_tpu_torch.runtime.fleet`
  — the reference's heterogeneous programs over a host-CPU lane and a CUDA
  lane (``Engine``/``EngineConfig``: approach 1 and 2; ``FleetEngine``/
  ``LaneSpec``: N weighted lanes), with :mod:`hipe_tpu_torch.parallel`
  (partitioner, device discovery, ratio calibration),
  :mod:`hipe_tpu_torch.profiling` (stage clocks, the 8-section report, the
  CSV corpus) and :mod:`hipe_tpu_torch.runtime.stream` (the input streams).

The package imports ``torch`` and never ``jax``. Importing it loads nothing
heavy: the exports below resolve on first use.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "DeviceStreamRunner":
        from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

        return DeviceStreamRunner
    if name in ("Engine", "EngineConfig"):
        from hipe_tpu_torch.runtime import engine

        return getattr(engine, name)
    if name in ("FleetEngine", "LaneSpec"):
        from hipe_tpu_torch.runtime import fleet

        return getattr(fleet, name)
    if name == "ServingPipeline":
        from hipe_tpu_torch.runtime.serve import ServingPipeline

        return ServingPipeline
    if name == "decode_coefficients":
        from hipe_tpu_torch.ops.jpeg_decode import decode_coefficients

        return decode_coefficients
    if name == "encode_bytes_device":
        from hipe_tpu_torch.ops.jpeg_encode import encode_bytes_device

        return encode_bytes_device
    if name in ("Pipeline", "PIPELINES", "GlobalStatsPipeline"):
        from hipe_tpu_torch.models import pipelines

        return getattr(pipelines, name)
    if name in ("filter_chain", "register_lut_filter", "register_rank_filter",
                "register_kernel_filter"):
        from hipe_tpu_torch.ops import blur

        return getattr(blur, name)
    raise AttributeError(name)
