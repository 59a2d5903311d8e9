"""Filter pipelines — the deployable "models" of the engine.

The counterpart of ``hipe_tpu.models.pipelines``. A pipeline is a named
chain of integer-exact uint8 filters with these paths:
:meth:`Pipeline.__call__` on channels-last batches (plain PyTorch, any
device); :meth:`Pipeline.apply_planar` on planar ``(N, H, W)`` planes, the
stream's hot path; and :meth:`Pipeline.apply_rows` / :meth:`Pipeline.apply_nhwc`
on interleaved rows ``(B, H, W*C)`` and channels-last batches, the layout of
the serving path and the library boundary. On the card they run the
hand-written CUDA kernels.

On the card :func:`hipe_tpu_torch.ops.planar.filter_planar` chooses the
kernel of a planar chain: K1 for a single gaussian, K2 for every other band
and point chain, K3 for a chain with a rank or registered-kernel stage, K4
and K5 stage by stage for planes too wide for K2's or K3's shared memory.

:class:`GlobalStatsPipeline` carries ``hipe_tpu``'s global-statistics
family (equalize, autocontrast, contrast, color, sharpness, mode, mode5):
PyTorch ops from :mod:`hipe_tpu_torch.ops.equalize`, as they are XLA ops in
``hipe_tpu``, run in chunks of whole images at stream scale; sharpness's
SMOOTH plane runs K3 (K5 for planes too wide for it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar

import numpy as np
import torch

from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import equalize as eq
from hipe_tpu_torch.ops import planar
from hipe_tpu_torch.ops.chain_program import check_stages
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_rows_cuda


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A named uint8->uint8 filter chain of ported stages."""

    name: str
    filters: tuple

    def __post_init__(self):
        object.__setattr__(self, "filters", check_stages(self.filters))

    @property
    def radius(self) -> int:
        """Total stencil radius (halo rows needed per side for row-split)."""
        return tblur.chain_radius(self.filters)

    @property
    def single_gaussian(self) -> bool:
        """Whether the chain is one gaussian stage (K1's; K2 or K3 runs the rest)."""
        return len(self.filters) == 1 and self.filters[0] in tblur.GAUSSIANS

    def routes_tiled(self, h: int, w: int) -> bool:
        """Whether :meth:`apply_planar` sends (h, w) planes to K4/K5."""
        return planar.routes_tiled(h, w, self.filters)

    def launch_candidates(self, h: int, w: int, device) -> list[tuple[str, dict, str | None]]:
        """The autotune's (label, config, reason to skip or None) for (h, w)
        planes: the launch knob of the route :meth:`apply_planar` takes
        (:func:`hipe_tpu_torch.ops.planar.launch_candidates`) on any device."""
        return planar.launch_candidates(h, w, self.filters)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Plain path on (..., H, W, C) uint8 batches."""
        return tblur.filter_chain(x, self.filters)

    def apply_planar(self, planes: torch.Tensor, *, h_pad: bool = True,
                     rows_per_block: int | None = None, tile=None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
        """Planar (N, H, W) path: K1, K2 or K3 on the card, or K4 and K5 for
        planes too wide for them (:func:`hipe_tpu_torch.ops.planar.filter_planar`);
        plain on the CPU.

        ``h_pad=False`` treats H as halo-padded by :attr:`radius` rows per
        side and returns the valid interior (row-split shard mode), on
        either route. ``rows_per_block`` is the fused kernels' launch knob,
        ``tile`` the tiled kernels'.
        """
        return planar.filter_planar(planes, self.filters, h_pad=h_pad,
                                    rows_per_block=rows_per_block, tile=tile, out=out)

    def apply_rows(self, rows: torch.Tensor, channels: int, *, h_pad: bool = True,
                   rows_per_block: int | None = None, tile=None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
        """Interleaved rows ``(B, H, W*C)`` uint8, ``hipe_tpu``'s device
        layout for channels-last data.

        A single gaussian runs K1's rows entry with no relayout (K1 takes
        rows of any width); every other chain relayouts on the card to
        planar, runs :meth:`apply_planar` (K2, K3 or K4/K5) and relayouts
        back. On the CPU the path is the plain rows chain.
        ``h_pad=False`` returns the valid interior ``(B, H - 2R, W*C)``.
        """
        b, h, lane = rows.shape
        if channels < 1 or lane % channels:
            raise ValueError(f"row length {lane} is not a multiple of {channels} channels")
        w = lane // channels
        if rows.device.type == "cpu":
            y = tblur.filter_chain_rows(rows, channels, self.filters, h_pad=h_pad)
            return y if out is None else out.copy_(y)
        if self.single_gaussian:
            return gaussian_blur_rows_cuda(rows, channels, self.radius, h_pad=h_pad,
                                           rows_per_block=rows_per_block, out=out)
        planes = rows.view(b, h, w, channels).permute(0, 3, 1, 2).contiguous()
        planes = planes.view(b * channels, h, w)
        res = self.apply_planar(planes, h_pad=h_pad, rows_per_block=rows_per_block,
                                tile=tile)
        ho = res.shape[1]
        back = res.view(b, channels, ho, w).permute(0, 2, 3, 1)
        if out is None:
            return back.reshape(b, ho, lane)
        out.view(b, ho, w, channels).copy_(back)
        return out

    def apply_nhwc(self, x: torch.Tensor, *, h_pad: bool = True,
                   out: torch.Tensor | None = None, **kw) -> torch.Tensor:
        """``(B, H, W, C)`` wrapper over :meth:`apply_rows` (a free reshape)."""
        b, h, w, c = x.shape
        rows_out = None if out is None else out.view(b, out.shape[1], w * c)
        y = self.apply_rows(x.reshape(b, h, w * c), c, h_pad=h_pad, out=rows_out, **kw)
        return y.view(b, y.shape[1], w, c)


# Bytes of temporaries a pixel that each global-statistics op holds at once
# over a chunk of planes (its int64 gather index, int32 luma and blend
# terms, float32 products; mode's int16 padded plane and keys and its uint8
# counts, 9 or 25 of them), rounded up.
STATS_TEMP_BYTES = {"equalize": 12, "autocontrast": 20, "contrast": 20, "color": 36,
                    "sharpness": 40, "mode": 28, "mode5": 48}
# The temporaries a chunk may hold: at the 5000-image stream's 983 MB an
# unchunked equalize on the CPU route would take 7.9 GB of int64 index
# alone, mode5 some 47 GB.
STATS_CHUNK_BYTES = 2 ** 31


def global_stats_chunk(h: int, w: int, channels: int, name: str,
                       device: str | torch.device = "cpu") -> int:
    """Planes a chunk of a stream-scale global-statistics apply on
    ``device``: the most whole images (a multiple of ``channels``, as planar
    layout is image-major) whose temporaries fit :data:`STATS_CHUNK_BYTES`,
    at least one image. Every statistic is an image's, so chunks give the
    same bytes as one call (``hipe_tpu``'s ``_global_stats_chunk``, which
    sizes its chunks for a TPU's HBM). On a CUDA device an op of
    :attr:`GlobalStatsPipeline.CARD_ROUTES` holds its route's bytes a
    plane, so a stream is one chunk."""
    per_plane = h * w * STATS_TEMP_BYTES[name]
    if torch.device(device).type == "cuda" and name in GlobalStatsPipeline.CARD_ROUTES:
        per_plane = GlobalStatsPipeline.CARD_ROUTES[name][1]
    return channels * max(1, STATS_CHUNK_BYTES // (channels * per_plane))


@dataclasses.dataclass(frozen=True)
class GlobalStatsPipeline:
    """A per-image global-statistics pipeline (no stencil radius).

    ``name`` selects the op of :mod:`hipe_tpu_torch.ops.equalize`:

    - ``equalize``: PIL ``ImageOps.equalize``, a histogram and LUT a plane;
    - ``autocontrast``: PIL ``ImageOps.autocontrast``; ``cutoff`` (integer
      percent or (low, high) percents) trims the histogram first, and
      ``preserve_tone`` takes one Pillow-luma range an image;
    - ``contrast``: PIL ``ImageEnhance.Contrast`` (one luma mean an image);
    - ``color``: PIL ``ImageEnhance.Color`` (a blend a pixel with its luma);
    - ``sharpness``: PIL ``ImageEnhance.Sharpness`` (a blend with the SMOOTH
      plane, which K3 computes on the card, and PIL's border copy);
    - ``mode`` / ``mode5``: PIL ``ImageFilter.ModeFilter(3 | 5)``.

    ``factor`` is contrast/color/sharpness's strength (1.0, the registry's,
    is the identity). ``channels`` is the channel count of *planar* inputs,
    which :meth:`apply_planar` groups as ``b*channels + c``; rows and
    channels-last inputs carry their own. The apply methods take and ignore
    the fused kernels' launch knobs (``rows_per_block``, ``tile``), so the
    runtime's call sites work unchanged, and write into ``out=`` when it is
    given. On CUDA tensors every op runs on the card.
    """

    # The ops whose card route runs hand-written kernels: the route's
    # autotune label and the bytes of temporaries it holds a plane, not a
    # pixel (equalize's K8-K10: an int32 histogram and a uint8 table).
    CARD_ROUTES: ClassVar[dict] = {"equalize": ("cuda_k8_k10", 256 * 4 + 256)}

    name: str
    filters: tuple = ()
    cutoff: object = 0
    preserve_tone: bool = False
    factor: float = 1.0
    channels: int = 3

    def __post_init__(self):
        if self.name not in STATS_TEMP_BYTES:
            raise KeyError(f"unknown global-statistics op {self.name!r} "
                           f"(choose from {sorted(STATS_TEMP_BYTES)})")
        if not self.filters:
            object.__setattr__(self, "filters", (self.name,))
        if self.cutoff != 0 and self.name != "autocontrast":
            raise ValueError(f"cutoff applies to 'autocontrast' only, not {self.name!r}")
        if self.preserve_tone and self.name != "autocontrast":
            raise ValueError(f"preserve_tone applies to 'autocontrast' only, not {self.name!r}")
        if self.factor != 1.0 and self.name not in ("contrast", "color", "sharpness"):
            raise ValueError(f"factor applies to 'contrast'/'color'/'sharpness' only, "
                             f"not {self.name!r}")
        if self.name == "autocontrast":
            eq._normalize_cutoff(self.cutoff)  # fail at construction
        if self.name in ("contrast", "color", "sharpness") and not (
                isinstance(self.factor, (int, float)) and self.factor >= 0):
            raise ValueError(f"{self.name} factor must be a number >= 0, got {self.factor!r}")

    @property
    def radius(self) -> int:
        raise ValueError(
            f"pipeline {self.name!r} uses whole-image or cross-channel statistics and has "
            "no stencil radius: halo-based row-split (approach2) cannot run it. Use an "
            "image-level mode (approach1/stream/serve); row-split runs these ops only "
            "once ROADMAP.md item 9 (sharding) is ported.")

    @property
    def params(self) -> str:
        """The op's settings as text (empty at the registry's defaults)."""
        if self.name == "autocontrast":
            tone = ", preserve_tone" if self.preserve_tone else ""
            return f"cutoff {self.cutoff}{tone}" if self.cutoff or tone else ""
        if self.name in ("contrast", "color", "sharpness"):
            return f"factor {float(self.factor)}"
        return ""

    def launch_candidates(self, h: int, w: int, device) -> list[tuple[str, dict, str | None]]:
        """One autotune config, no knob of its own (sharpness's K3 or K5
        routes itself), named after the op's route on ``device``: its
        :attr:`CARD_ROUTES` label on a CUDA device, else ``torch_ops``."""
        card = torch.device(device).type == "cuda" and self.name in self.CARD_ROUTES
        return [(self.CARD_ROUTES[self.name][0] if card else "torch_ops", {}, None)]

    def _planar_fn(self, channels: int):
        """The planar op with this pipeline's settings, grouping ``channels``."""
        fn = getattr(eq, f"{self.name}_planar")
        if self.name == "autocontrast":
            return functools.partial(fn, channels=channels, cutoff=self.cutoff,
                                     preserve_tone=self.preserve_tone)
        if self.name in ("contrast", "color", "sharpness"):
            return functools.partial(fn, channels=channels, factor=float(self.factor))
        return functools.partial(fn, channels=channels)

    def _chunked(self, planes: torch.Tensor, channels: int,
                 out: torch.Tensor | None) -> torch.Tensor:
        """The op over (N, H, W) planes in chunks of :func:`global_stats_chunk`."""
        fn = self._planar_fn(channels)
        n, h, w = planes.shape
        k = global_stats_chunk(h, w, channels, self.name, planes.device)
        if n <= k:
            return fn(planes, out=out)
        if out is None:
            out = torch.empty_like(planes)
        for i in range(0, n, k):
            fn(planes[i:i + k], out=out[i:i + k])
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H, W, C) uint8, any leading axes or none."""
        return eq._nhwc_via_rows(self.apply_rows, x)

    def apply_planar(self, planes: torch.Tensor, *, h_pad: bool = True,
                     rows_per_block: int | None = None, tile=None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
        """Planar ``(B*channels, H, W)`` uint8; ``h_pad=False`` raises."""
        if not h_pad:
            raise ValueError(f"pipeline {self.name!r}: halo (h_pad=False) mode is "
                             "meaningless for a global-statistics op")
        return self._chunked(planes, self.channels, out)

    def apply_rows(self, rows: torch.Tensor, channels: int, *, h_pad: bool = True,
                   rows_per_block: int | None = None, tile=None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
        """Interleaved rows ``(B, H, W*C)`` uint8: a relayout to planar, the
        chunked op grouping ``channels``, a relayout back."""
        if not h_pad:
            raise ValueError(f"pipeline {self.name!r}: halo (h_pad=False) mode is "
                             "meaningless for a global-statistics op")
        res = eq._rows_via_planar(lambda planes, c: self._chunked(planes, c, None), rows,
                                  channels)
        return res if out is None else out.copy_(res)

    def apply_nhwc(self, x: torch.Tensor, *, h_pad: bool = True,
                   out: torch.Tensor | None = None, **kw) -> torch.Tensor:
        """``(B, H, W, C)`` wrapper over :meth:`apply_rows` (a free reshape)."""
        b, h, w, c = x.shape
        rows_out = None if out is None else out.view(b, h, w * c)
        return self.apply_rows(x.reshape(b, h, w * c), c, h_pad=h_pad, out=rows_out,
                               **kw).view(b, h, w, c)

    def oracle(self, img: np.ndarray) -> np.ndarray:
        """The op's NumPy oracle on one (H, W, C) or (H, W) image."""
        if self.name == "autocontrast":
            return eq.autocontrast_oracle(img, self.cutoff, self.preserve_tone)
        if self.name in ("contrast", "color", "sharpness"):
            return getattr(eq, f"{self.name}_oracle")(img, float(self.factor))
        if self.name in ("mode", "mode5"):
            return eq.mode_oracle(img, 5 if self.name == "mode5" else 3)
        return eq.equalize_oracle(img)


PIPELINES = {
    "blur3": Pipeline("blur3", ("gaussian3",)),
    "blur5": Pipeline("blur5", ("gaussian5",)),
    "blur7": Pipeline("blur7", ("gaussian7",)),
    "blur9": Pipeline("blur9", ("gaussian9",)),
    "sharpen": Pipeline("sharpen", ("sharpen",)),
    "edge": Pipeline("edge", ("edge",)),
    "chain": Pipeline("chain", ("gaussian3", "sharpen", "edge")),
    "median": Pipeline("median", ("median",)),
    "denoise": Pipeline("denoise", ("median", "gaussian3")),
    # Morphology: 3x3 min/max rank filters (PIL MinFilter/MaxFilter) and the
    # opening/closing compositions.
    "erode": Pipeline("erode", ("erode",)),
    "dilate": Pipeline("dilate", ("dilate",)),
    "open": Pipeline("open", ("erode", "dilate")),
    "close": Pipeline("close", ("dilate", "erode")),
    # 5x5/7x7/9x9 rank filters (PIL MedianFilter(n)).
    "median5": Pipeline("median5", ("median5",)),
    "median7": Pipeline("median7", ("median7",)),
    "median9": Pipeline("median9", ("median9",)),
    "invert": Pipeline("invert", ("invert",)),
    "solarize": Pipeline("solarize", ("solarize",)),
    "posterize": Pipeline("posterize", ("posterize4",)),
    "equalize": GlobalStatsPipeline("equalize"),
    "autocontrast": GlobalStatsPipeline("autocontrast"),
    "contrast": GlobalStatsPipeline("contrast"),
    "color": GlobalStatsPipeline("color"),
    "sharpness": GlobalStatsPipeline("sharpness"),
    # PIL ImageFilter.ModeFilter: truncated (not clamped) windows.
    "mode": GlobalStatsPipeline("mode"),
    "mode5": GlobalStatsPipeline("mode5"),
}



def get(name_or_filters) -> Pipeline | GlobalStatsPipeline:
    """A pipeline by name, a bare stage name, or a sequence of stage names.

    Follows ``hipe_tpu.models.pipelines.get``: a constructed pipeline is
    returned as it is, a bare stage (registered ones included) is a
    one-stage pipeline and a sequence is named by joining its stages with
    ``+``. The global-statistics names are pipelines, not chainable stages.
    An unknown name raises ``KeyError``.
    """
    if isinstance(name_or_filters, (Pipeline, GlobalStatsPipeline)):
        return name_or_filters
    if isinstance(name_or_filters, str):
        name = name_or_filters
        if name in PIPELINES:
            return PIPELINES[name]
        if name in tblur.FILTERS:
            return Pipeline(name, (name,))
        raise KeyError(
            f"unknown pipeline {name!r} (choose from {sorted(PIPELINES)} or "
            f"the stages {sorted(tblur.FILTERS)})")
    names = check_stages(name_or_filters)
    return Pipeline("+".join(names), names)
