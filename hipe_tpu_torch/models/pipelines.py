"""Filter pipelines — the deployable "models" of the engine.

The counterpart of ``hipe_tpu.models.pipelines``. A pipeline is a named
chain of integer-exact uint8 filters with two paths: :meth:`Pipeline.__call__`
on channels-last batches (plain PyTorch, any device) and
:meth:`Pipeline.apply_planar` on planar ``(N, H, W)`` planes, the stream's
hot path, which runs kernel K1 on the card.

This slice of the port carries the single-Gaussian pipelines ``blur3/5/7/9``;
the other pipelines of ``hipe_tpu`` are listed in ROADMAP.md as still to be
ported.
"""

from __future__ import annotations

import dataclasses

import torch

from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A named uint8->uint8 filter chain (one Gaussian stage in this slice)."""

    name: str
    filters: tuple

    def __post_init__(self):
        if len(self.filters) != 1 or self.filters[0] not in tblur.FILTER_RADIUS:
            raise ValueError(
                f"pipeline {self.name!r}: only single gaussian stages are "
                f"ported so far ({sorted(tblur.FILTER_RADIUS)}), got "
                f"{self.filters!r}; see ROADMAP.md")

    @property
    def radius(self) -> int:
        """Total stencil radius (halo rows needed per side for row-split)."""
        return tblur.FILTER_RADIUS[self.filters[0]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Plain path on (..., H, W, C) uint8 batches."""
        return tblur.gaussian_blur(x, self.radius)

    def apply_planar(self, planes: torch.Tensor, *, h_pad: bool = True,
                     rows_per_block: int | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
        """Planar (N, H, W) path: kernel K1 on the card, plain on the CPU.

        ``h_pad=False`` treats H as halo-padded by :attr:`radius` rows per
        side and returns the valid interior (row-split shard mode).
        """
        return gaussian_blur_planar_cuda(
            planes, self.radius, h_pad=h_pad, rows_per_block=rows_per_block,
            out=out)


PIPELINES = {
    "blur3": Pipeline("blur3", ("gaussian3",)),
    "blur5": Pipeline("blur5", ("gaussian5",)),
    "blur7": Pipeline("blur7", ("gaussian7",)),
    "blur9": Pipeline("blur9", ("gaussian9",)),
}


def get(name: str | Pipeline) -> Pipeline:
    if isinstance(name, Pipeline):
        return name
    if name in PIPELINES:
        return PIPELINES[name]
    raise KeyError(
        f"pipeline {name!r} is not ported to hipe_tpu_torch yet (ported: "
        f"{sorted(PIPELINES)}); ROADMAP.md lists the order of the rest")
