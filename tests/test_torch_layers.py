"""The port's layers point one way, and its kernels launch through one seam.

``hipe_tpu_torch/ops/`` is a set of leaves: no module of it imports
``models`` or ``runtime``, no ``cuda_*`` wrapper imports another, and only
``ops/_build.py`` loads the kernels' library. The runner sweeps what its
pipeline offers without knowing a kernel. Every module is read with
``ast``, imports inside functions included. The launcher of
``_build.entry`` is run here against a stand-in entry point.
"""

import ast
import contextlib
import types
from pathlib import Path

import pytest
import torch

import hipe_tpu_torch
from hipe_tpu_torch.ops import (_build, cuda_blur, cuda_chain, cuda_dct, cuda_equalize,
                                cuda_rank_chain, cuda_tiled)

PKG = Path(hipe_tpu_torch.__file__).resolve().parent
OPS_MODULES = sorted(p.stem for p in (PKG / "ops").glob("*.py"))


def _imports(path: Path, package: str) -> set[str]:
    """Every module ``path`` imports, at any depth, as dotted names;
    ``from a import b`` counts ``a`` and ``a.b``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.split(".")[:len(package.split(".")) - node.level + 1]
                base = ".".join([*parent, *([base] if base else [])])
            names.add(base)
            names.update(f"{base}.{alias.name}" for alias in node.names)
    return names


@pytest.mark.parametrize("name", OPS_MODULES)
def test_ops_module_reaches_neither_up_nor_sideways(name):
    path = PKG / "ops" / f"{name}.py"
    imported = _imports(path, "hipe_tpu_torch.ops")
    assert not sorted(m for m in imported if m.startswith(
        ("hipe_tpu_torch.models", "hipe_tpu_torch.runtime")))
    if name.startswith("cuda_"):
        assert not sorted(m for m in imported if m.startswith("hipe_tpu_torch.ops.cuda_")
                          and m.split(".")[2] != name)
    if name != "_build":
        text = path.read_text()
        assert "hipe_cuda_error_string" not in text and "load_library" not in text


def test_the_runner_sweeps_what_the_pipeline_offers():
    path = PKG / "runtime" / "device_stream.py"
    assert not sorted(m for m in _imports(path, "hipe_tpu_torch.runtime")
                      if m.startswith("hipe_tpu_torch.ops.cuda_"))
    names_compared = [
        node.lineno for node in ast.walk(ast.parse(path.read_text()))
        if isinstance(node, ast.Compare)
        and any(isinstance(side, ast.Attribute) and side.attr == "name"
                for side in (node.left, *node.comparators))]
    assert names_compared == []


@pytest.mark.parametrize("wrapper,symbol", [
    (cuda_blur.gaussian_blur_planar_cuda, "hipe_blur_planar_u8"),
    (cuda_blur.gaussian_blur_rows_cuda, "hipe_blur_rows_u8"),
    (cuda_chain.filter_chain_planar_cuda, "hipe_chain_planar_u8"),
    (cuda_chain.filter_chain_rows_cuda, "hipe_chain_rows_u8"),
    (cuda_rank_chain.rank_chain_planar_cuda, "hipe_rank_chain_planar_u8"),
    (cuda_tiled.gaussian_blur_planar_tiled_cuda, "hipe_tiled_blur_planar_u8"),
    (cuda_tiled.filter_stage_planar_tiled_cuda, "hipe_tiled_stage_planar_u8"),
    (cuda_dct.dequant_idct_cuda, "hipe_dequant_idct_s16"),
    (cuda_dct.fdct_quantize_cuda, "hipe_fdct_quantize_u8"),
    (cuda_equalize.histogram_planes_cuda, "hipe_equalize_histogram_u8"),
    (cuda_equalize.equalize_lut_cuda, "hipe_equalize_lut_u8"),
    (cuda_equalize.apply_lut_planar_cuda, "hipe_equalize_apply_u8"),
], ids=lambda v: getattr(v, "__name__", None))
def test_each_wrapper_owns_its_launcher_and_counter(wrapper, symbol):
    assert wrapper.launch.symbol == symbol and wrapper.launch.owner is wrapper
    assert isinstance(wrapper.launches, int)
    assert wrapper.launch.argtypes[-1] is _build.P  # the stream, appended


def test_the_launcher_raises_with_the_callers_text_and_counts_once(monkeypatch):
    calls, loads, entered = [], [], []

    def stand_in(*args):  # a C entry point: success, then an illegal access
        calls.append(args)
        return 0 if len(calls) == 1 else 700

    lib = types.SimpleNamespace(
        hipe_stand_in=stand_in,
        hipe_cuda_error_string=lambda rc: b"an illegal memory access was encountered")
    monkeypatch.setattr(_build, "load_library", lambda: loads.append(1) or lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: entered.append(dev) or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    _build._error_string.cache_clear()
    try:
        @_build.entry("hipe_stand_in", _build.P, _build.I)
        def wrapper(x):
            wrapper.launch(x, lambda: f"stand_in launch failed for {tuple(x.shape)}",
                           x.data_ptr(), 7)

        x = torch.zeros(3, dtype=torch.uint8)
        assert wrapper.launches == 0 and loads == []  # nothing loads before a launch
        wrapper(x)
        assert wrapper.launches == 1 and calls == [(x.data_ptr(), 7, 1234)]
        assert entered == [x.device]
        assert stand_in.argtypes == [_build.P, _build.I, _build.P] and stand_in.restype is _build.I
        with pytest.raises(RuntimeError, match=r"^stand_in launch failed for \(3,\): an illegal "
                                               r"memory access was encountered \(cudaError 700\)$"):
            wrapper(x)
        assert wrapper.launches == 1 and len(calls) == 2
    finally:
        _build._error_string.cache_clear()
