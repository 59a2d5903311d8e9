"""Each fault is written once for any point a driver may declare: a
function or a plain method, with ``out=`` or without; ``altered`` also at
a point whose output is a list or tuple of tensors, ``unchanged`` and
``half`` only at one whose output is one tensor of its input's shape.
Planted on a stand-in module, each does what it says."""

import sys
import types

import pytest
import torch

import faults


def _double(x):
    return x * 2


class _Codec:
    def apply(self, x, *, out=None):
        return _double(x) if out is None else out.copy_(_double(x))

    def planes(self, x):
        return [_double(x), x + 1]

    def encode(self, x):
        return _double(x), x + 1, x.to(torch.float32) / 2

    def count(self, x):
        return x.sum(dim=1)


@pytest.fixture
def stand_in(monkeypatch):
    mod = types.ModuleType("stand_in_program")
    mod.double, mod.Codec = _double, _Codec
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


X = torch.arange(32, dtype=torch.int16).view(8, 4)


def _half_of(y, x):
    """``y`` with rows 4: (the second half, whole images of 2 rows) from ``x``."""
    return torch.cat([y[:4], x[4:]])


def _altered(y):
    y = y.clone()
    y[-1, -1] = y[-1, -1] + 1 if y.is_floating_point() else y[-1, -1] ^ 1
    return y


@pytest.mark.parametrize("fault,want", [
    (faults.unchanged, lambda x: x),
    (faults.half, lambda x: _half_of(_double(x), x)),
    (faults.altered, lambda x: _altered(_double(x)))], ids=faults.FAULTS)
def test_function_and_method_with_and_without_out(stand_in, monkeypatch, fault, want):
    faults.plant(monkeypatch, "stand_in_program:double", fault, 2)
    faults.plant(monkeypatch, "stand_in_program:Codec.apply", fault, 2)
    assert torch.equal(stand_in.double(X), want(X))
    assert torch.equal(stand_in.Codec().apply(X), want(X))
    out = torch.empty_like(X)
    assert stand_in.Codec().apply(X, out=out) is out and torch.equal(out, want(X))


@pytest.mark.parametrize("method,kind", [("planes", list), ("encode", tuple)])
def test_altered_in_each_component(stand_in, monkeypatch, method, kind):
    sound = getattr(stand_in.Codec(), method)(X)
    faults.plant(monkeypatch, f"stand_in_program:Codec.{method}", faults.altered, 2)
    got = getattr(stand_in.Codec(), method)(X)
    assert isinstance(got, kind) and len(got) == len(sound)
    assert all(torch.equal(g, _altered(s)) for g, s in zip(got, sound))


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half],
                         ids=["unchanged", "half"])
@pytest.mark.parametrize("method", ["planes", "count"])
def test_unchanged_and_half_need_an_output_shaped_like_the_input(
        stand_in, monkeypatch, fault, method):
    faults.plant(monkeypatch, f"stand_in_program:Codec.{method}", fault, 2)
    with pytest.raises(TypeError, match="input's shape"):
        getattr(stand_in.Codec(), method)(X)


def test_planting_is_undone(stand_in, monkeypatch):
    with monkeypatch.context() as m:
        faults.plant(m, "stand_in_program:Codec.apply", faults.unchanged, 2)
        assert torch.equal(stand_in.Codec().apply(X), X)
    assert torch.equal(stand_in.Codec().apply(X), _double(X))


@pytest.mark.parametrize("point", ["stand_in_program", "stand_in_program:Codec.nothing"])
def test_a_point_that_does_not_resolve_raises(stand_in, point):
    with pytest.raises((ValueError, AttributeError)):
        faults.resolve(point)
