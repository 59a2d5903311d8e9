"""Photo-like uint8 images made from a seed, on the device, in chunks.

Each plane (one channel of one image) is a smooth field plus noise: a base
level, a linear gradient, one low-frequency wave and Gaussian noise, each
drawn from the seed for that plane, clamped to [0, 255] and truncated. So
every image has a histogram of its own, spread over many bins, and edges
and noise for the stencils to work on. The reference's JPEG assets are not
in the repository; these stand in for them.

Images come in chunks of :data:`CHUNK`, each made by its own generator
seeded from (seed, chunk index), so any range of images can be made again
alone and the result depends on the seed and the device's arithmetic only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 250


def chunk_seed(seed: int, k: int) -> int:
    """A 63-bit generator seed for chunk ``k`` of the stream of ``seed``."""
    words = np.random.SeedSequence([seed % 2 ** 64, k]).generate_state(1, np.uint64)
    return int(words[0] >> np.uint64(1))


def _chunk(k: int, h: int, w: int, c: int, seed: int, params: dict, device) -> torch.Tensor:
    """Chunk ``k``: (CHUNK, c, h, w) uint8."""
    g = torch.Generator(device=device)
    g.manual_seed(chunk_seed(seed, k))
    m = CHUNK * c
    u = torch.rand((m, 8), generator=g, device=device, dtype=torch.float32)

    def span(i, lo, hi):
        return (lo + (hi - lo) * u[:, i]).view(m, 1, 1)

    x = torch.linspace(-0.5, 0.5, w, device=device).view(1, 1, w)
    y = torch.linspace(-0.5, 0.5, h, device=device).view(1, h, 1)
    grad = params["gradient"]
    v = (span(0, *params["base"]) + span(1, -grad, grad) * x + span(2, -grad, grad) * y)
    cycles = params["wave_cycles"]
    phase = (span(3, 0.0, cycles) * x + span(4, 0.0, cycles) * y) * (2 * math.pi)
    v += span(5, 0.0, params["wave_amplitude"]) * torch.sin(phase + span(6, 0.0, 2 * math.pi))
    v += span(7, *params["noise_sigma"]) * torch.randn((m, h, w), generator=g, device=device)
    return v.clamp_(0, 255).to(torch.uint8).view(CHUNK, c, h, w)


def images(first: int, count: int, shape: tuple, seed: int, params: dict, device):
    """Yield (start, (n, c, h, w) uint8) blocks covering images
    ``[first, first + count)`` of the stream, one chunk at a time."""
    _, h, w, c = shape
    end = first + count
    k = first // CHUNK
    while k * CHUNK < end:
        lo, hi = max(first, k * CHUNK), min(end, (k + 1) * CHUNK)
        block = _chunk(k, h, w, c, seed, params, device)
        yield lo, block[lo - k * CHUNK: hi - k * CHUNK]
        k += 1


def planar(first: int, count: int, shape: tuple, seed: int, params: dict,
           device) -> torch.Tensor:
    """Images ``[first, first + count)`` as planar (count*c, h, w) uint8."""
    _, h, w, c = shape
    out = torch.empty((count * c, h, w), dtype=torch.uint8, device=device)
    fill_planar(out, first, shape, seed, params, device)
    return out


def fill_planar(dst: torch.Tensor, first: int, shape: tuple, seed: int, params: dict,
                device) -> None:
    """Write images ``[first, first + dst.shape[0] // c)`` into planar ``dst``."""
    c = shape[3]
    for lo, block in images(first, dst.shape[0] // c, shape, seed, params, device):
        n = block.shape[0]
        dst[(lo - first) * c:(lo - first + n) * c].copy_(block.reshape(n * c, *block.shape[2:]))
