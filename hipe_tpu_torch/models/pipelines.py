"""Filter pipelines — the deployable "models" of the engine.

The counterpart of ``hipe_tpu.models.pipelines``. A pipeline is a named
chain of integer-exact uint8 filters with two paths: :meth:`Pipeline.__call__`
on channels-last batches (plain PyTorch, any device) and
:meth:`Pipeline.apply_planar` on planar ``(N, H, W)`` planes, the stream's
hot path, which runs the hand-written CUDA kernels on the card.

Single gaussians (``blur3/5/7/9``) run K1, every other chain of band and
point stages runs the fused chain kernel K2, and every chain with a rank or
registered-kernel stage runs K3, as ``hipe_tpu`` routes them to its blur
kernel, ``_chain_mxu_kernel`` and ``_chain_kernel``. The global-statistics
pipelines of ``hipe_tpu`` are listed in ROADMAP.md as still to be ported.
"""

from __future__ import annotations

import dataclasses

import torch

from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda
from hipe_tpu_torch.ops.cuda_chain import check_stages, filter_chain_planar_cuda


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

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Plain path on (..., H, W, C) uint8 batches."""
        return tblur.filter_chain(x, self.filters)

    def apply_planar(self, planes: torch.Tensor, *, h_pad: bool = True,
                     rows_per_block: int | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
        """Planar (N, H, W) path: K1, K2 or K3 on the card, plain on the CPU.

        ``h_pad=False`` treats H as halo-padded by :attr:`radius` rows per
        side and returns the valid interior (row-split shard mode).
        """
        if self.single_gaussian:
            return gaussian_blur_planar_cuda(
                planes, self.radius, h_pad=h_pad,
                rows_per_block=rows_per_block, out=out)
        return filter_chain_planar_cuda(
            planes, self.filters, h_pad=h_pad, rows_per_block=rows_per_block,
            out=out)


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
}

# The global-statistics pipelines of hipe_tpu, which this package does not
# carry yet; ROADMAP.md lists their order.
UNPORTED_PIPELINES = frozenset({
    "equalize", "autocontrast", "contrast", "color", "sharpness", "mode", "mode5",
})


def get(name_or_filters) -> Pipeline:
    """A pipeline by name, a bare stage name, or a sequence of stage names.

    Follows ``hipe_tpu.models.pipelines.get``: a bare stage (registered
    ones included) is a one-stage pipeline and a sequence is named by
    joining its stages with ``+``. A pipeline that ``hipe_tpu`` has but
    this package does not carry yet, and an unknown name, raise
    ``KeyError``.
    """
    if isinstance(name_or_filters, Pipeline):
        return name_or_filters
    if isinstance(name_or_filters, str):
        name = name_or_filters
        if name in PIPELINES:
            return PIPELINES[name]
        if name in tblur.FILTERS:
            return Pipeline(name, (name,))
        if name in UNPORTED_PIPELINES:
            raise KeyError(
                f"pipeline {name!r} is not ported to hipe_tpu_torch yet "
                f"(ported: {sorted(PIPELINES)} and the stages "
                f"{sorted(tblur.FILTERS)}); ROADMAP.md lists the order of "
                "the rest")
        raise KeyError(
            f"unknown pipeline {name!r} (choose from {sorted(PIPELINES)} or "
            f"the stages {sorted(tblur.FILTERS)}; ROADMAP.md lists what is "
            "still to be ported)")
    names = check_stages(name_or_filters)
    return Pipeline("+".join(names), names)
