"""Reference of ``mode5``: PIL's ``ImageFilter.ModeFilter(5)``, a plane at a time.

As Pillow's ``ModeFilter.c`` computes it, for each pixel: the 256-bin
histogram of its 5x5 window, truncated at the image's bounds (positions
outside the plane count nowhere); the first bin of the highest count; that
value where the count exceeds 2, else the pixel itself.

The histograms are one-hot planes summed over the window: each plane's
256 one-hot planes are zero-padded by 2, and a box of 5 summed along the
rows and then along the columns, so a window's counts at the border are
those of its truncated part. The choice is the largest of the single key
``count * 256 + (255 - value)``, held in ``dtype``: the highest count, and
on a tie the lowest value. Every key is an integer of at most 25 * 256 +
255 = 6655, so float32 holds each exactly and gives Pillow's bytes;
bfloat16 (the control) keeps 8 significant bits, rounds the value out of
the key and does not.

The planes go through in sub-blocks of at most :data:`BLOCK_COUNTS`
counts (a plane of 240x320 takes 19,660,800), so a block of 500 RGB
images fits the card.
"""

import torch
import torch.nn.functional as F

SIZE = 5
# Counts (planes x 256 bins x pixels) a sub-block holds at once: ~0.5 GB
# of uint8 counts and ~2 GB of float32 keys.
BLOCK_COUNTS = 2 ** 29


def _sub_block(x: torch.Tensor, dtype) -> torch.Tensor:
    """(P, H, W) uint8 -> (P, H, W) uint8."""
    p, h, w = x.shape
    r = SIZE // 2
    bins = torch.arange(256, device=x.device, dtype=torch.uint8).view(1, 256, 1, 1)
    onehot = F.pad((x[:, None] == bins).to(torch.uint8), (r, r, r, r))
    rows = onehot[..., 0:w].clone()
    for dx in range(1, SIZE):
        rows += onehot[..., dx:dx + w]
    del onehot
    counts = rows[:, :, 0:h].clone()
    for dy in range(1, SIZE):
        counts += rows[:, :, dy:dy + h]
    del rows
    key = counts.to(dtype).mul_(256).add_(
        (255 - torch.arange(256, device=x.device)).to(dtype).view(1, 256, 1, 1))
    del counts
    best = key.amax(dim=1)
    del key
    count = torch.floor(best / 256)
    value = 255 - (best - count * 256)
    return torch.where(count > 2, value.to(torch.uint8), x)


def apply(planes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W) uint8."""
    n, h, w = planes.shape
    step = max(1, BLOCK_COUNTS // (256 * h * w))
    return torch.cat([_sub_block(planes[i:i + step], dtype) for i in range(0, n, step)])
