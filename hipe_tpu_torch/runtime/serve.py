"""Decode -> filter -> encode serving over JPEG streams (``hipe_tpu``'s
``runtime/serve.py`` on the card).

Four placements of the codec, as ``ServingPipeline.process_batch`` picks
them (each gives the same bytes):

- host decode + host encode: libjpeg decodes whole images on the host
  thread pool, the filter runs on the card, libjpeg encodes;
- ``decode_on_device``: the host decodes only the entropy layer, and the
  card dequantizes, runs the IDCT (K6), upsamples and converts colour
  together with the filter;
- ``encode_on_device``: the card filters, converts colour, downsamples and
  runs fDCT + quantize (K7); the host entropy-encodes the coefficients;
- both: the full transcode on the card, coefficients in and coefficients
  out (:meth:`ServingPipeline.transcode_fn`), so no pixel crosses to the
  host.

Payloads are grouped by (geometry, quant tables), one device call a group;
a geometry the device decoder does not take falls back to the host decode.
``run`` overlaps the host stage of batch k+1 with the device work of batch
k. The filter is ``Pipeline.apply_rows``: for blur3, K1's rows entry.

The entropy layer needs the native libjpeg codec
(:mod:`hipe_tpu_torch.io_.jpeg`), and raises where it cannot be built.
``hipe_tpu``'s resize, thumbnail, scaled-decode, grayscale and colorize
stages are not ported yet: their options stay in the signature and raise
``ValueError`` unless left at their defaults (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from hipe_tpu_torch.io_ import jpeg as jio
from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import jpeg_decode as jd
from hipe_tpu_torch.ops import jpeg_encode as je


def now_ms() -> float:
    """Monotonic wall clock in ms."""
    return time.perf_counter() * 1000.0


@dataclasses.dataclass
class ServeStats:
    images: int = 0
    decode_ms: float = 0.0
    device_ms: float = 0.0
    encode_ms: float = 0.0
    wall_ms: float = 0.0

    @property
    def img_per_s(self) -> float:
        return self.images / (self.wall_ms / 1000.0) if self.wall_ms else 0.0


# hipe_tpu's serving options that select stages this package does not carry
# yet, with their defaults.
UNPORTED_OPTIONS = {"output_scale": 1, "resize_to": None, "decode_scale": 1,
                    "gray_output": False, "decode_gray": False, "colorize": None}


class ServingPipeline:
    """decode -> filter -> encode with host/device overlap."""

    def __init__(
        self,
        pipeline: plib.Pipeline | str = "blur3",
        *,
        device=None,
        quality: int = 90,
        decode_threads: int | None = None,
        decode_on_device: bool = False,
        encode_on_device: bool = False,
        encode_subsampling: str = "420",
        encode_progressive: bool = False,
        encode_arithmetic: bool = False,
        encode_restart_interval: int = 0,
        encode_optimize: bool = False,
        output_scale: int = 1,
        resize_to: tuple | None = None,
        decode_scale: int = 1,
        gray_output: bool = False,
        decode_gray: bool = False,
        colorize=None,
    ):
        given = {"output_scale": output_scale, "resize_to": resize_to,
                 "decode_scale": decode_scale, "gray_output": gray_output,
                 "decode_gray": decode_gray, "colorize": colorize}
        for name, default in UNPORTED_OPTIONS.items():
            value = given[name]
            if (value is not None) if default is None else (value != default):
                raise ValueError(f"{name}={value!r}: this serving stage is not ported to "
                                 "hipe_tpu_torch yet; ROADMAP.md lists it")
        self.pipeline = plib.get(pipeline)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but torch.cuda.is_available() "
                               "is False: serving runs on an NVIDIA GPU (device='cpu' serves "
                               "only the plain-version parity checks)")
        if encode_subsampling not in je.DEVICE_SUBSAMPLINGS:
            raise ValueError(f"encode_subsampling must be one of "
                             f"{'/'.join(je.DEVICE_SUBSAMPLINGS)}, got {encode_subsampling!r}")
        self.quality = quality
        self.decode_threads = decode_threads
        self.decode_on_device = decode_on_device
        self.encode_on_device = encode_on_device
        self.encode_subsampling = encode_subsampling
        # The entropy options change only the host entropy layer, never the
        # coefficients, so every placement's bytes stay identical.
        self.encode_progressive = encode_progressive
        self.encode_arithmetic = encode_arithmetic
        self.encode_restart_interval = encode_restart_interval
        self.encode_optimize = encode_optimize
        self._enc_qtabs = jio.quality_tables(quality)
        # Overlaps the host stages with device work; the entropy coding runs
        # GIL-free in the native batch calls.
        self._pool = ThreadPoolExecutor(max_workers=decode_threads or os.cpu_count() or 4)
        self.stats = ServeStats()

    def close(self) -> None:
        """Release the host-stage worker threads (idempotent)."""
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _entropy_options(self) -> dict:
        return {"progressive": self.encode_progressive, "arithmetic": self.encode_arithmetic,
                "restart_interval": self.encode_restart_interval,
                "optimize": self.encode_optimize}

    def _enc_tables(self, channels: int) -> list:
        luma, chroma = self._enc_qtabs
        return [luma] if channels == 1 else [luma, chroma, chroma]

    # ---- host decode and encode ----

    def _decode(self, payloads: list[bytes]) -> np.ndarray:
        t0 = now_ms()
        batch = jio.decode_batch(payloads, num_threads=self.decode_threads)
        if batch.shape[-1] == 4:
            raise ValueError("4-component (CMYK) JPEG serving is not supported; decode "
                             "with hipe_tpu_torch.io_.jpeg.decode_bytes instead")
        self.stats.decode_ms += now_ms() - t0
        return batch

    def _filter_device(self, batch: np.ndarray) -> np.ndarray:
        """(B, H, W, C) pixels -> the filter on the card -> host pixels."""
        t0 = now_ms()
        b, h, w, c = batch.shape
        rows = torch.from_numpy(batch.reshape(b, h, w * c)).to(self.device)
        out = self.pipeline.apply_rows(rows, c).cpu().numpy()
        self.stats.device_ms += now_ms() - t0
        return out.reshape(b, h, w, c)

    def _encode(self, batch: np.ndarray) -> list[bytes]:
        if self.encode_on_device:
            return self._encode_device(batch)
        t0 = now_ms()

        def enc(im):
            return jio.encode_bytes_opts(im, self.quality, subsampling=self.encode_subsampling,
                                         **self._entropy_options())

        out = list(self._pool.map(enc, batch))
        self.stats.encode_ms += now_ms() - t0
        return out

    # ---- device encode: colour/downsample/fDCT/quantize on the card ----

    def encode_fn(self, h: int, w: int, c: int, with_filter: bool):
        """rows (B, H, W*C) on the card -> per-component coefficients, with
        the filter first if ``with_filter``."""
        geo = je.encode_geometry(h, w, c, self.encode_subsampling)
        qtables = self._enc_tables(c)
        pipe = self.pipeline

        def fn(rows: torch.Tensor) -> list[torch.Tensor]:
            if with_filter:
                rows = pipe.apply_rows(rows, c)
            return je.encode_planes(geo, rows.reshape(rows.shape[0], h, w, c), qtables)

        return fn

    def _entropy_encode(self, coefs: list[np.ndarray], h: int, w: int,
                        channels: int) -> list[bytes]:
        """Host entropy encode of per-component coefficient batches: one
        native batch call."""
        t0 = now_ms()
        out = jio.write_coefficients_batch(
            coefs, w, h, quality=self.quality,
            subsampling=self.encode_subsampling if channels == 3 else "444",
            num_threads=self.decode_threads, **self._entropy_options())
        self.stats.encode_ms += now_ms() - t0
        return out

    def _encode_device(self, batch: np.ndarray, with_filter: bool = False) -> list[bytes]:
        """Pixels -> JPEG bytes through the device encoder (filtering too
        with ``with_filter``): one host-to-device copy, coefficients back."""
        t0 = now_ms()
        b, h, w, c = batch.shape
        rows = torch.from_numpy(batch.reshape(b, h, w * c)).to(self.device)
        coefs = [x.cpu().numpy() for x in self.encode_fn(h, w, c, with_filter)(rows)]
        self.stats.device_ms += now_ms() - t0
        return self._entropy_encode(coefs, h, w, c)

    # ---- device decode: entropy decode on the host, the rest on the card ----

    def _read_coefs(self, payloads: list[bytes]) -> list:
        """Host entropy decode (one GIL-free native batch call)."""
        t0 = now_ms()
        cos = jio.read_coefficients_batch(payloads, num_threads=self.decode_threads)
        self.stats.decode_ms += now_ms() - t0
        return cos

    def _groups(self, cos: list) -> dict:
        """{(geometry, quant tables): payload indices}."""
        groups: dict[tuple, list[int]] = {}
        for i, co in enumerate(cos):
            qkey = tuple(tuple(int(v) for v in c.qtable) for c in co.components)
            groups.setdefault((jd.geometry_of(co), qkey), []).append(i)
        return groups

    def _coefs_to_device(self, cos: list, idxs: list[int], ncomps: int) -> list[torch.Tensor]:
        return [torch.from_numpy(np.stack([cos[i].components[ci].coefs for i in idxs]))
                .to(self.device) for ci in range(ncomps)]

    def decode_filter_fn(self, geo: jd.DecodeGeometry, qkey: tuple):
        """coefficients on the card -> decode -> filter -> (B, H, W, C)."""
        qtables = list(qkey)
        pipe = self.pipeline

        def fn(*comp_coefs: torch.Tensor) -> torch.Tensor:
            rows = jd.decode_planes(geo, list(comp_coefs), qtables, layout="rows")
            out = pipe.apply_rows(rows, geo.ncomps)
            return out.reshape(out.shape[0], geo.height, geo.width, geo.ncomps)

        return fn

    def _filter_device_coefs(self, payloads: list[bytes], cos=None) -> np.ndarray:
        """Entropy decode on the host, decode + filter on the card."""
        if cos is None:
            cos = self._read_coefs(payloads)
        out: list[np.ndarray | None] = [None] * len(cos)
        for (geo, qkey), idxs in self._groups(cos).items():
            if not jd.supported(geo):
                res = self._filter_device(self._decode([payloads[i] for i in idxs]))
            else:
                t0 = now_ms()
                comp = self._coefs_to_device(cos, idxs, geo.ncomps)
                res = self.decode_filter_fn(geo, qkey)(*comp).cpu().numpy()
                self.stats.device_ms += now_ms() - t0
            for j, i in enumerate(idxs):
                out[i] = res[j]
        if len({o.shape for o in out}) > 1:
            raise ValueError("mixed-resolution batch cannot return one pixel array; use "
                             "uniform-size batches or encode=True")
        return np.stack(out)

    def transcode_fn(self, geo: jd.DecodeGeometry, qkey: tuple):
        """The full numeric transcode on the card, for one (geometry, quant
        tables) group: ``fn(*comp_coefs) -> [coefs]``, decode (K6 a
        component), the filter (K1's rows entry for blur3), encode (K7 a
        component)."""
        qtables = list(qkey)
        c = geo.ncomps
        encode = self.encode_fn(geo.height, geo.width, c, with_filter=True)

        def fn(*comp_coefs: torch.Tensor) -> list[torch.Tensor]:
            return encode(jd.decode_planes(geo, list(comp_coefs), qtables, layout="rows"))

        return fn

    def _transcode_device_coefs(self, payloads: list[bytes], cos=None) -> list[bytes]:
        """Entropy decode -> the card -> entropy encode."""
        if cos is None:
            cos = self._read_coefs(payloads)
        out: list[bytes | None] = [None] * len(cos)
        for (geo, qkey), idxs in self._groups(cos).items():
            if not jd.supported(geo):
                res = self._encode_device(self._decode([payloads[i] for i in idxs]),
                                          with_filter=True)
            else:
                t0 = now_ms()
                comp = self._coefs_to_device(cos, idxs, geo.ncomps)
                coefs = [x.cpu().numpy() for x in self.transcode_fn(geo, qkey)(*comp)]
                self.stats.device_ms += now_ms() - t0
                res = self._entropy_encode(coefs, geo.height, geo.width, geo.ncomps)
            for j, i in enumerate(idxs):
                out[i] = res[j]
        return out

    def process_batch(self, payloads: list[bytes],
                      encode: bool = True) -> list[bytes] | np.ndarray:
        """One batch, synchronously: decode -> filter -> (encode)."""
        if encode and self.encode_on_device:
            if self.decode_on_device:
                return self._transcode_device_coefs(payloads)
            return self._encode_device(self._decode(payloads), with_filter=True)
        if self.decode_on_device:
            filtered = self._filter_device_coefs(payloads)
        else:
            filtered = self._filter_device(self._decode(payloads))
        return self._encode(filtered) if encode else filtered

    def run(self, payload_batches: Iterable[list[bytes]],
            encode: bool = True) -> Iterator[list[bytes] | np.ndarray]:
        """Streaming: the host stage of batch k+1 (the whole decode, or the
        entropy decode with ``decode_on_device``) overlaps the device stage
        of batch k."""
        fuse_encode = encode and self.encode_on_device
        if self.decode_on_device:
            def host_stage(p):
                return p, self._read_coefs(p)

            def device_stage(arg):
                payloads, cos = arg
                self.stats.images += len(payloads)
                if fuse_encode:
                    return self._transcode_device_coefs(payloads, cos)
                return self._filter_device_coefs(payloads, cos)
        else:
            def host_stage(p):
                return self._decode(p)

            def device_stage(batch):
                self.stats.images += len(batch)
                if fuse_encode:
                    return self._encode_device(batch, with_filter=True)
                return self._filter_device(batch)

        t_start = now_ms()
        pending = None
        for payloads in payload_batches:
            fut = self._pool.submit(host_stage, payloads)
            if pending is not None:
                res = device_stage(pending.result())
                yield self._encode(res) if encode and not fuse_encode else res
            pending = fut
        if pending is not None:
            res = device_stage(pending.result())
            yield self._encode(res) if encode and not fuse_encode else res
        self.stats.wall_ms += now_ms() - t_start
