"""Decode -> filter -> encode serving over JPEG streams (``hipe_tpu``'s
``runtime/serve.py`` on the card).

Four placements of the codec, as ``ServingPipeline.process_batch`` picks
them (each gives the same bytes):

- host decode + host encode: libjpeg decodes whole images on the host
  thread pool, the filter runs on the card, libjpeg encodes;
- ``decode_on_device``: the host decodes only the entropy layer, and the
  card dequantizes, runs the IDCT (K6), upsamples and converts colour
  (K11 for 4:2:0 and 4:4:4) together with the filter;
- ``encode_on_device``: the card filters, converts colour, downsamples and
  runs fDCT + quantize (K7); the host entropy-encodes the coefficients;
- both: the full transcode on the card, coefficients in and coefficients
  out (:meth:`ServingPipeline.transcode_fn`), so no pixel crosses to the
  host.

Payloads are grouped by (geometry, quant tables), one device call a group;
a geometry the device decoder does not take, and every 4-component
(CMYK/YCCK) stream, falls back to the host decode, which refuses 4-channel
serving. ``run`` overlaps the host stage of batch k+1 with the device work
of batch k. The filter is ``Pipeline.apply_rows``: for blur3, K1's rows
entry; for a ``GlobalStatsPipeline``, its PyTorch ops on the batch's device
(``decode_gray`` runs them 1-channel).

``hipe_tpu``'s serving options apply in every placement, in its order:
scaled decode (``decode_scale``: libjpeg's DCT-domain 1/2, 1/4, 1/8; and
``decode_gray``: the luma alone) -> filter -> ``resize_to`` (the Q14
bilinear of :mod:`hipe_tpu_torch.ops.resize`) or ``output_scale=2`` (an
exact 2x2 average) -> ``gray_output`` (jccolor.c's luma) -> ``colorize`` (a
(3, 256) table, :func:`hipe_tpu_torch.ops.equalize.colorize_lut`) ->
encode. On the card the decode runs K6 (or the reduced IDCTs), the encode
K7, whatever the options.

The entropy layer needs the native libjpeg codec
(:mod:`hipe_tpu_torch.io_.jpeg`), and raises where it cannot be built.
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
from hipe_tpu_torch.ops.resize import resize_bilinear
from hipe_tpu_torch.profiling.trace import span


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
        # output_scale=2: after the filter, an exact 2x2 average (jcsample.c's
        # h2v2 rounding a channel, odd dims edge-replicated) halves each side.
        if output_scale not in (1, 2):
            raise ValueError(f"output_scale must be 1 or 2, got {output_scale}")
        self.output_scale = output_scale
        # resize_to=(H, W): after the filter, the Q14 bilinear to exactly (H, W).
        if resize_to is not None:
            rh, rw = resize_to
            if output_scale == 2:
                raise ValueError("resize_to and output_scale=2 are mutually exclusive")
            if not (isinstance(rh, int) and isinstance(rw, int) and rh > 0 and rw > 0):
                raise ValueError(f"resize_to must be positive ints, got {resize_to!r}")
            resize_to = (rh, rw)
        self.resize_to = resize_to
        # gray_output: colour leaves as jccolor.c's luma, after filter and
        # resize, and is encoded 1-component (grayscale inputs pass).
        self.gray_output = gray_output
        # decode_gray: colour streams decode to their luma at the source
        # (libjpeg's JCS_GRAYSCALE) and the whole pipeline runs 1-channel.
        self.decode_gray = decode_gray
        # colorize: a 1-channel stage output -> RGB through three wedge tables.
        if colorize is not None:
            colorize = np.asarray(colorize, dtype=np.uint8)
            if colorize.shape != (3, 256):
                raise ValueError(f"colorize expects a (3, 256) LUT (see "
                                 f"ops.equalize.colorize_lut), got {colorize.shape}")
        self.colorize = colorize
        self._colorize_key = None if colorize is None else hash(colorize.tobytes())
        self._colorize_table = (None if colorize is None else
                                torch.from_numpy(colorize.T.copy()).to(self.device))
        # decode_scale=2/4/8: libjpeg's DCT-domain scaled decode; the image
        # enters the filter at ceil(dim / decode_scale).
        if decode_scale not in (1, 2, 4, 8):
            raise ValueError(f"decode_scale must be 1, 2, 4 or 8, got {decode_scale}")
        self.decode_scale = decode_scale
        self._enc_qtabs = jio.quality_tables(quality)
        # The device functions, keyed by group and every option.
        self._fns: dict[tuple, object] = {}
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

    def _options_key(self) -> tuple:
        """Every option that shapes a device function."""
        return (self.encode_subsampling, self.output_scale, self.resize_to, self.decode_scale,
                self.gray_output, self.decode_gray, self._colorize_key)

    def _enc_tables(self, channels: int) -> list:
        luma, chroma = self._enc_qtabs
        return [luma] if channels == 1 else [luma, chroma, chroma]

    # ---- the stages after the filter ----

    def _out_dims(self, h: int, w: int) -> tuple[int, int]:
        """Output pixel dims after the optional downscale or resize."""
        if self.resize_to is not None:
            return self.resize_to
        if self.output_scale == 2:
            return -(-h // 2), -(-w // 2)
        return h, w

    def _gray_c(self, c: int) -> int:
        """Channel count after the gray_output stage."""
        return 1 if (self.gray_output and c == 3) else c

    def _out_c(self, c: int) -> int:
        """Output channel count (gray_output then colorize, in order)."""
        c1 = self._gray_c(c)
        return 3 if self.colorize is not None and c1 == 1 else c1

    def _scaled_in_dims(self, h: int, w: int) -> tuple[int, int]:
        """Pixel dims entering the filter after the scaled decode."""
        s = self.decode_scale
        return -(-h // s), -(-w // s)

    def _colorize_rows(self, rows: torch.Tensor, b: int, h: int, w: int,
                       c1: int) -> torch.Tensor:
        """The wedge tables on rows, (b, h, w) -> (b, h, w*3); ``c1`` is the
        channel count after gray_output. PIL's colorize takes L images
        only, so a 3-channel stage output is a configuration error."""
        if self.colorize is None:
            return rows
        if c1 != 1:
            raise ValueError("colorize needs a grayscale stage output (use decode_gray or "
                             f"gray_output, or feed 1-channel streams); got {c1} channels")
        idx = rows.reshape(-1).to(torch.int32)
        return self._colorize_table.index_select(0, idx).reshape(b, h, w * 3)

    def _gray_rows(self, rows: torch.Tensor, b: int, h: int, w: int,
                   c: int) -> torch.Tensor:
        """jccolor.c's luma on rows, (b, h, w*3) -> (b, h, w)."""
        if not (self.gray_output and c == 3):
            return rows
        return je.rgb_to_gray(rows.reshape(b, h, w, c)).to(torch.uint8)

    def _post_filter_rows(self, rows: torch.Tensor, b: int, h: int, w: int,
                          c: int) -> torch.Tensor:
        """The output's size on rows: the resize or the 2x thumbnail."""
        if self.resize_to is not None:
            oh, ow = self.resize_to
            return resize_bilinear(rows.reshape(b, h, w, c), oh, ow).reshape(b, oh, ow * c)
        if self.output_scale == 2:
            return self._downscale_rows(rows, b, h, w, c)
        return rows

    def _downscale_rows(self, rows: torch.Tensor, b: int, h: int, w: int,
                        c: int) -> torch.Tensor:
        """Exact 2x thumbnail: odd dims edge-replicated to even (jcsample.c's
        expansion), then jcsample.c's h2v2 average a channel."""
        img = rows.reshape(b, h, w, c).to(torch.int32).permute(0, 3, 1, 2)
        img = je._pad_edge(img, 2 * -(-h // 2), 2 * -(-w // 2))
        small = je.downsample_h2v2(img).permute(0, 2, 3, 1).to(torch.uint8)
        return small.reshape(b, small.shape[1], small.shape[2] * c)

    def _post_filter(self, rows: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
        """Filtered rows (B, h, w*c) -> resize or thumbnail -> gray ->
        colorize: (B, oh, ow*oc), in batch chunks (their int32 temporaries)."""
        if (self.resize_to is None and self.output_scale == 1 and self._gray_c(c) == c
                and self.colorize is None):
            return rows
        oh, ow = self._out_dims(h, w)
        b = rows.shape[0]
        out = torch.empty((b, oh, ow * self._out_c(c)), dtype=torch.uint8, device=rows.device)
        for s in jd._chunks(b, h * w):
            n = out[s].shape[0]
            x = self._post_filter_rows(rows[s], n, h, w, c)
            x = self._gray_rows(x, n, oh, ow, c)
            out[s] = self._colorize_rows(x, n, oh, ow, self._gray_c(c))
        return out

    # ---- host decode and encode ----

    def _decode(self, payloads: list[bytes]) -> np.ndarray:
        t0 = now_ms()
        if self.decode_scale > 1:
            batch = jio.decode_batch_scaled(payloads, 1, self.decode_scale,
                                            num_threads=self.decode_threads,
                                            force_gray=self.decode_gray)
        else:
            batch = jio.decode_batch(payloads, num_threads=self.decode_threads,
                                     force_gray=self.decode_gray)
        if batch.shape[-1] == 4:
            raise ValueError("4-component (CMYK) JPEG serving is not supported; decode "
                             "with hipe_tpu_torch.io_.jpeg.decode_bytes or "
                             "ops.jpeg_decode.decode_coefficients instead")
        self.stats.decode_ms += now_ms() - t0
        return batch

    def _filter_device(self, batch: np.ndarray) -> np.ndarray:
        """(B, H, W, C) pixels -> the filter and the later stages on the
        card -> host pixels."""
        t0 = now_ms()
        b, h, w, c = batch.shape
        rows = torch.from_numpy(batch.reshape(b, h, w * c)).to(self.device)
        out = self._post_filter(self.pipeline.apply_rows(rows, c), h, w, c).cpu().numpy()
        self.stats.device_ms += now_ms() - t0
        oh, ow = self._out_dims(h, w)
        return out.reshape(b, oh, ow, self._out_c(c))

    def _encode(self, batch: np.ndarray) -> list[bytes]:
        if self.encode_on_device:
            return self._encode_device(batch)
        t0 = now_ms()
        gray = self.gray_output and batch.shape[-1] == 3 and self.colorize is None

        def enc(im):
            return jio.encode_bytes_opts(im, self.quality, subsampling=self.encode_subsampling,
                                         gray_from_rgb=gray, **self._entropy_options())

        out = list(self._pool.map(enc, batch))
        self.stats.encode_ms += now_ms() - t0
        return out

    # ---- device encode: colour/downsample/fDCT/quantize on the card ----

    def encode_fn(self, h: int, w: int, c: int, with_filter: bool):
        """rows (B, H, W*C) on the card -> per-component coefficients, with
        the filter and the stages after it first if ``with_filter`` (then
        one ``codec.filter`` span, with the rows' device time)."""
        oh, ow = self._out_dims(h, w) if with_filter else (h, w)
        oc = self._out_c(c) if with_filter else c
        geo = je.encode_geometry(oh, ow, oc, self.encode_subsampling)
        qtables = self._enc_tables(oc)
        pipe = self.pipeline

        def fn(rows: torch.Tensor) -> list[torch.Tensor]:
            if with_filter:
                with span("codec.filter", rows.device):
                    rows = self._post_filter(pipe.apply_rows(rows, c), h, w, c)
            return je.encode_planes(geo, rows.reshape(rows.shape[0], oh, ow, oc), qtables)

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
        oh, ow = self._out_dims(h, w) if with_filter else (h, w)
        return self._entropy_encode(coefs, oh, ow, self._out_c(c) if with_filter else c)

    # ---- device decode: entropy decode on the host, the rest on the card ----

    def _read_coefs(self, payloads: list[bytes]) -> list:
        """Host entropy decode (one GIL-free native batch call)."""
        t0 = now_ms()
        cos = jio.read_coefficients_batch(payloads, num_threads=self.decode_threads)
        self.stats.decode_ms += now_ms() - t0
        return cos

    def _maybe_gray_geo(self, geo: jd.DecodeGeometry, qkey: tuple):
        """With decode_gray, a colour stream whose luma is at full
        resolution reduces to its luma's geometry; any other keeps its own
        and the host decodes it gray."""
        if (self.decode_gray and geo.ncomps == 3
                and geo.comps[0][:2] == (geo.max_h, geo.max_v)):
            return jd.gray_geometry(geo), (qkey[0],)
        return geo, qkey

    def _groups(self, cos: list) -> dict:
        """{(geometry, quant tables): payload indices}."""
        groups: dict[tuple, list[int]] = {}
        for i, co in enumerate(cos):
            qkey = tuple(tuple(int(v) for v in c.qtable) for c in co.components)
            groups.setdefault(self._maybe_gray_geo(jd.geometry_of(co), qkey), []).append(i)
        return groups

    def _on_card(self, geo: jd.DecodeGeometry) -> bool:
        """Whether a group decodes on the card. 4-component streams go to the
        host decode, which refuses them."""
        return geo.ncomps != 4 and jd.supported_scaled(geo, self.decode_scale)

    def _coefs_to_device(self, cos: list, idxs: list[int], ncomps: int) -> list[torch.Tensor]:
        return [torch.from_numpy(np.stack([cos[i].components[ci].coefs for i in idxs]))
                .to(self.device) for ci in range(ncomps)]

    def decode_filter_fn(self, geo: jd.DecodeGeometry, qkey: tuple):
        """coefficients on the card -> (scaled) decode -> filter -> the
        stages after it -> (B, OH, OW, OC)."""
        key = ("decode", geo, qkey, *self._options_key())
        if key not in self._fns:
            qtables, pipe, denom = list(qkey), self.pipeline, self.decode_scale
            h, w = self._scaled_in_dims(geo.height, geo.width)
            c = geo.ncomps
            oh, ow = self._out_dims(h, w)

            def fn(*comp_coefs: torch.Tensor) -> torch.Tensor:
                rows = jd.decode_planes_scaled(geo, list(comp_coefs), qtables, denom,
                                               layout="rows")
                out = self._post_filter(pipe.apply_rows(rows, c), h, w, c)
                return out.reshape(out.shape[0], oh, ow, self._out_c(c))

            self._fns[key] = fn
        return self._fns[key]

    def _filter_device_coefs(self, payloads: list[bytes], cos=None) -> np.ndarray:
        """Entropy decode on the host, decode + filter on the card."""
        if cos is None:
            cos = self._read_coefs(payloads)
        out: list[np.ndarray | None] = [None] * len(cos)
        for (geo, qkey), idxs in self._groups(cos).items():
            if not self._on_card(geo):
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
        tables) group: ``fn(*comp_coefs) -> [coefs]``, the (scaled) decode
        (K6 a component, or the reduced IDCTs), the filter (K1's rows entry
        for blur3), the stages after it, encode (K7 a component). A call is
        one host-only ``serve.transcode`` span (``profiling/trace.py``)."""
        key = ("transcode", geo, qkey, *self._options_key())
        if key not in self._fns:
            qtables, denom = list(qkey), self.decode_scale
            h, w = self._scaled_in_dims(geo.height, geo.width)
            encode = self.encode_fn(h, w, 3 if geo.ncomps == 3 else 1, with_filter=True)

            def fn(*comp_coefs: torch.Tensor) -> list[torch.Tensor]:
                with span("serve.transcode"):
                    return encode(jd.decode_planes_scaled(geo, list(comp_coefs), qtables,
                                                          denom, layout="rows"))

            self._fns[key] = fn
        return self._fns[key]

    def _transcode_device_coefs(self, payloads: list[bytes], cos=None) -> list[bytes]:
        """Entropy decode -> the card -> entropy encode."""
        if cos is None:
            cos = self._read_coefs(payloads)
        out: list[bytes | None] = [None] * len(cos)
        for (geo, qkey), idxs in self._groups(cos).items():
            if not self._on_card(geo):
                res = self._encode_device(self._decode([payloads[i] for i in idxs]),
                                          with_filter=True)
            else:
                t0 = now_ms()
                comp = self._coefs_to_device(cos, idxs, geo.ncomps)
                coefs = [x.cpu().numpy() for x in self.transcode_fn(geo, qkey)(*comp)]
                self.stats.device_ms += now_ms() - t0
                oh, ow = self._out_dims(*self._scaled_in_dims(geo.height, geo.width))
                res = self._entropy_encode(coefs, oh, ow,
                                           self._out_c(3 if geo.ncomps == 3 else 1))
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
