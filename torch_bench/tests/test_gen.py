"""The image generator: the same seed gives the same images, another seed
others; chunks made alone equal the stream; images differ from each other."""

import harness
import torch

CELL = harness.resolve("stream_blur3")
SHAPE = (600, 24, 20, 3)
PARAMS = CELL.config["images"]
GEN = CELL.generator()


def _planar(first, count, seed):
    return GEN.planar(first, count, SHAPE, seed, PARAMS, "cpu")


def test_same_seed_same_images_other_seed_others():
    big = 2 ** 31 + 12345
    a, b, c = _planar(0, 300, big), _planar(0, 300, big), _planar(0, 300, big + 1)
    assert torch.equal(a, b)
    assert (a != c).float().mean() > 0.5


def test_a_range_made_alone_equals_the_stream():
    whole = _planar(0, 600, 9)
    part = _planar(240, 30, 9)  # crosses a chunk boundary
    assert torch.equal(part, whole[240 * 3:270 * 3])


def test_images_are_distinct_with_their_own_histograms():
    x = _planar(0, 300, 4).view(300, 3, -1)
    hists = torch.stack([torch.bincount(p.long(), minlength=256) for p in x[:, 0]])
    assert len({tuple(h.tolist()) for h in hists}) == 300
    assert (hists > 0).sum(dim=1).float().mean() > 30  # spread over many bins
    assert len({bytes(im.numpy()) for im in x}) == 300
