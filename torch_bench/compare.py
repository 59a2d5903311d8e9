"""The comparison that decides ``correct``: exact, image by image."""

from __future__ import annotations

import torch

# The configurations state bit-exact integer output: every limit is 0.
LIMIT = 0


class Tally:
    """Accumulates the comparison of blocks of images: the largest absolute
    difference of an element, and the images with any difference."""

    def __init__(self):
        self.max_abs_err = 0
        self.wrong_images = 0
        self.compared = 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        """``got`` and ``want``: (images, ...) integers of at most 16 bits
        (uint8 pixels, int16 coefficients) on one device, compared in int32
        so that no difference wraps. A block whose shape differs counts
        every image of ``want`` as wrong."""
        n = want.shape[0]
        self.compared += n
        if got.shape != want.shape:
            self.wrong_images += n
            self.max_abs_err = max(self.max_abs_err, 255)
            return
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs().reshape(n, -1).amax(dim=1)
        self.max_abs_err = max(self.max_abs_err, int(diff.max()))
        self.wrong_images += int((diff > 0).sum())

    def checks(self) -> dict:
        return {"max_abs_err": {"value": self.max_abs_err, "limit": LIMIT},
                "wrong_images": {"value": self.wrong_images, "limit": LIMIT}}
