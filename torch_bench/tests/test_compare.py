"""``compare.Tally`` counts an image wrong by its true largest difference:
int16 coefficients are compared in int32, so no difference wraps; uint8
pixels read as they always did."""

import pytest
import torch

from compare import Tally


def _tally(dtype, got, want):
    """Three images of ``dtype``, equal but for one element of the second:
    ``got`` against ``want``."""
    a = torch.zeros(3, 4, 5, dtype=dtype)
    b = a.clone()
    a[1, 2, 3], b[1, 2, 3] = got, want
    t = Tally()
    t.add(a, b)
    assert t.compared == 3
    return t.checks()


@pytest.mark.parametrize("got,want,err", [(1, 0, 1), (32767, 0, 32767),
                                          (16384, -16384, 32768), (-32768, 32767, 65535)],
                         ids=["by_1", "by_32767", "by_32768", "min_against_max"])
def test_int16_difference_counts_wrong_with_its_true_size(got, want, err):
    assert _tally(torch.int16, got, want) == {"max_abs_err": {"value": err, "limit": 0},
                                              "wrong_images": {"value": 1, "limit": 0}}


@pytest.mark.parametrize("got,want,err,wrong", [(0, 255, 255, 1), (7, 7, 0, 0)],
                         ids=["by_255", "equal"])
def test_uint8_reads_as_before(got, want, err, wrong):
    assert _tally(torch.uint8, got, want) == {"max_abs_err": {"value": err, "limit": 0},
                                              "wrong_images": {"value": wrong, "limit": 0}}
