"""The three faults of a cell of one chip, planted at the program callables
that the cell's driver names.

A driver declares, at module level:

- ``FAULT_POINTS``: for each fault (``unchanged``, ``half``, ``altered``)
  the callables it is planted at, as ``"module:Qualified.name"`` strings of
  ``hipe_tpu_torch``: a function of a module, or a plain method of a class;
- ``image_entries(cell)``: how many entries of a point's leading dimension
  one image takes;
- ``SETUP_PARTS``: the keys ``setup`` puts in ``window.setup_parts`` on the
  CPU.

A point's input is its first argument after ``self``. ``unchanged`` and
``half`` need a point whose output is one tensor of its input's shape, and
raise at any other; ``altered`` takes an output of one tensor or a list or
tuple of them, and acts on each. A point that takes ``out=`` gets the
faulty output copied into it.
"""

from __future__ import annotations

import importlib
import inspect

import torch

FAULTS = ("unchanged", "half", "altered")
PROGRAM = "hipe_tpu_torch"


def resolve(point: str):
    """``(owner, attribute)`` of a ``"module:Qualified.name"`` point."""
    module, _, qualname = point.partition(":")
    if not qualname:
        raise ValueError(f"point {point!r} is not 'module:Qualified.name'")
    owner = importlib.import_module(module)
    *path, attr = qualname.split(".")
    for part in path:
        owner = getattr(owner, part)
    if not callable(getattr(owner, attr)):
        raise TypeError(f"point {point!r} is not callable")
    return owner, attr


def check_declarations(driver, cells) -> None:
    """``driver`` declares each fault's points, resolved on the CPU to
    callables of the program, an image's entries for each of ``cells``,
    and its set-up parts."""
    assert set(driver.FAULT_POINTS) == set(FAULTS)
    for points in driver.FAULT_POINTS.values():
        assert points and not isinstance(points, str)
        for point in points:
            assert point.partition(":")[0].split(".")[0] == PROGRAM, point
            owner, attr = resolve(point)
            assert getattr(owner, attr).__module__.split(".")[0] == PROGRAM, point
            if inspect.isclass(owner):  # a plain method: its input follows self
                assert inspect.isfunction(inspect.getattr_static(owner, attr)), point
    assert driver.SETUP_PARTS and all(isinstance(k, str) for k in driver.SETUP_PARTS)
    for cell in cells:
        entries = driver.image_entries(cell)
        assert isinstance(entries, int) and entries >= 1


def _each(f, y, *others):
    """``f`` over a tensor, or over each tensor of a list or tuple (and the
    matching entries of ``others``)."""
    if isinstance(y, torch.Tensor):
        return f(y, *others)
    return type(y)(f(*parts) for parts in zip(y, *others))


def _shaped_like(y, x) -> torch.Tensor:
    """``y``, which has to be one tensor of ``x``'s shape."""
    if not (isinstance(y, torch.Tensor) and isinstance(x, torch.Tensor)
            and y.shape == x.shape):
        raise TypeError("an 'unchanged' or 'half' point must return one tensor "
                        "of its input's shape")
    return y


def unchanged(call, x, per_image):
    """The point returns its input."""
    _shaped_like(call(), x)
    return x.clone()


def half(call, x, per_image):
    """The second half of the images, whole images, left as they came in."""
    y = _shaped_like(call(), x).clone()
    k = x.shape[0] // 2
    k -= k % per_image
    y[k:] = x[k:]
    return y


def altered(call, x, per_image):
    """One element of each output altered where it is produced."""
    def alter(y):
        y = y.clone()
        at = (-1,) * y.dim()
        y[at] = y[at] + 1 if y.is_floating_point() else y[at] ^ 1
        return y
    return _each(alter, call())


def plant(monkeypatch, point: str, fault, per_image: int) -> None:
    """Replace ``point`` by ``fault`` around it, for the test's duration."""
    owner, attr = resolve(point)
    fn = getattr(owner, attr)
    lead = 1 if inspect.isclass(owner) else 0

    def faulty(*args, out=None, **kw):
        y = fault(lambda: fn(*args, **kw), args[lead], per_image)
        return y if out is None else _each(lambda o, v: o.copy_(v), out, y)

    monkeypatch.setattr(owner, attr, faulty)


def plant_all(monkeypatch, cell, name: str) -> None:
    """Fault ``name`` at every point the cell's driver declares for it."""
    driver = cell.driver()
    fault = {"unchanged": unchanged, "half": half, "altered": altered}[name]
    for point in driver.FAULT_POINTS[name]:
        plant(monkeypatch, point, fault, driver.image_entries(cell))
