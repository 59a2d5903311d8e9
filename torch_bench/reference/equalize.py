"""Reference of ``equalize``: PIL's ``ImageOps.equalize``, a plane at a time.

For each plane: the 256-bin histogram; ``step = (pixels - count of the
last non-empty bin) // 255``; with at most one non-empty bin, or ``step``
0, the identity; else ``lut[i] = (step // 2 + sum of bins below i) //
step``, at most 255; the plane mapped through its table. The histogram is
counted with ``torch.bincount``; the table's arithmetic runs in ``dtype``:
every value is an integer under 2^24 and every quotient is floored far from
rounding, so float32 gives PIL's integers, and bfloat16 (the control) does
not.
"""

import torch


def apply(planes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W) uint8."""
    n, h, w = planes.shape
    flat = planes.reshape(n, -1).long()
    rows = torch.arange(n, device=planes.device).view(n, 1) * 256
    hist = torch.bincount((flat + rows).view(-1), minlength=n * 256).view(n, 256)
    nonzero = hist > 0
    bins = torch.arange(256, device=planes.device)
    last = torch.where(nonzero, bins, -1).amax(dim=1).clamp(min=0)
    last_count = hist.gather(1, last.view(n, 1)).to(dtype)
    hd = hist.to(dtype)
    below = torch.cumsum(hd, dim=1) - hd
    step = torch.floor((h * w - last_count) / 255)
    safe = step.clamp(min=1)
    lut = torch.floor((torch.floor(safe / 2) + below) / safe).clamp(max=255)
    ident = (nonzero.sum(dim=1, keepdim=True) <= 1) | (step <= 0)
    lut = torch.where(ident, bins.to(dtype).expand(n, 256), lut).to(torch.uint8)
    return lut.gather(1, flat).view(n, h, w)
