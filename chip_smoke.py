#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each:

1. Environment: torch, CUDA, nvcc, Triton and the card's name and power
   limit. Fails unless ``torch.cuda.is_available()``; never runs on the CPU.
2. Builds kernels K1 (``hipe_tpu_torch/csrc/blur_planar.cu``), K2
   (``hipe_tpu_torch/csrc/chain_planar.cu``) and K3
   (``hipe_tpu_torch/csrc/rank_chain_planar.cu``) from the checkout's sources.
3. Holds K1 against its plain PyTorch version on distinct random planes:
   radius 1-4, clamp and valid modes, ragged shapes, one full-stream pass,
   and every ``rows_per_block`` the autotune sweeps. Max-abs error must be 0.
4. Holds K2 against its plain PyTorch chain the same way: band and point
   chains (a registered LUT among them), clamp and valid modes, ragged
   shapes, the full stream for ``chain``, every ``rows_per_block``.
5. Holds K3 against its plain PyTorch chain the same way: rank-family and
   registered-kernel chains (median, erode/dilate, median5/7/9, ``pil_*``
   presets, a registered rank, kernel and LUT), clamp and valid modes,
   ragged shapes, the full stream for ``denoise``, every ``rows_per_block``.
6. The blur3 main path: the 5000-image 256x256x3 stream through
   ``DeviceStreamRunner`` (autotune, verify against the NumPy oracle, three
   throughput sessions), with the launch counts taken over that run alone.
7. The chain main path (blur->sharpen->edge), the same way, verified
   against the pipeline's plain path.
8. The denoise main path (median -> gaussian3), the same way.
Each main path also compares the stream after 3 chained passes with the
plain version's and times the plain version's pass for the record; only the
path's own kernel may run on it (K1 blur3, K2 chain, K3 denoise).

Then one JSON line of per-kernel results, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises
and the script exits non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

NUM_IMAGES = 5000
SIDE = 256
CHANNELS = 3
PASSES = 10
SESSIONS = 3
# Planes per call of the plain version on the card: its int32 temporaries
# for the whole (15000, 256, 256) stream would be ~3.9 GB each.
PLAIN_CHUNK = 1000
SMALL_SHAPES = ((6, 240, 320), (5, 37, 53), (3, 1, 7), (2, 9, 1))
LUT_NAME = "dim"  # brightness_lut(0.7), registered in phase 4
RANK_NAME = "q"  # PIL RankFilter(5, 6), registered in phase 5
KERNEL_NAME = "tilt"  # an asymmetric 5x5 kernel, registered in phase 5
K2_CHAINS = (
    ("gaussian3", "sharpen", "edge"),
    ("sharpen",),
    ("edge",),
    ("invert",),
    ("sharpen", "invert"),
    ("gaussian5", "solarize"),
    ("posterize4", "gaussian9", "edge"),
    ("gaussian7",),
    (LUT_NAME, "gaussian3"),
    ("posterize1", "edge"),
)
K3_CHAINS = (
    ("median", "gaussian3"),
    ("erode", "dilate"),
    ("dilate", "erode"),
    ("median",),
    ("median5", "edge"),
    ("erode5", "dilate5"),
    ("median7",),
    ("posterize4", "median9"),
    ("pil_emboss", "gaussian3"),
    ("pil_find_edges", "pil_contour", "pil_smooth_more"),
    (RANK_NAME, "edge"),
    (LUT_NAME, KERNEL_NAME, "median"),
)


def _run(cmd: list[str]) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    lines = (proc.stdout.strip() or proc.stderr.strip() or "no output").splitlines()
    return next((ln for ln in lines if "release" in ln), lines[-1])


def phase_env() -> str:
    from hipe_tpu_torch.cli import gpu_name_and_power_limit
    from hipe_tpu_torch.ops import _build

    if importlib.util.find_spec("triton") is not None:
        import triton

        triton_version = triton.__version__
    else:
        triton_version = "absent"
    card = gpu_name_and_power_limit()
    try:
        nvcc = _run([_build.find_nvcc(), "--version"])
    except RuntimeError as e:
        nvcc = str(e)
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc '{nvcc}' triton {triton_version} card '{card}'", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: chip_smoke.py "
                         "runs only on an NVIDIA GPU")
    return card


def phase_build(card: str) -> None:
    from hipe_tpu_torch.ops import _build, cuda_blur, cuda_chain, cuda_rank_chain

    t0 = time.perf_counter()
    lib = _build.build()
    cuda_blur._kernel_lib()
    cuda_chain._kernel_lib()
    cuda_rank_chain._kernel_lib()
    secs = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text() if (lib.parent / "build.log").exists() else ""
    ptxas = "; ".join(ln.split("info    : ")[-1] for ln in log.splitlines()
                      if "Used" in ln)
    print(f"[2 build] {lib} in {secs:.2f} s (0 s: already built); ptxas: "
          f"{ptxas or 'no report'} [{card}]", flush=True)


def plain_chunked(x: torch.Tensor, names: tuple, h_pad: bool = True) -> torch.Tensor:
    """The plain PyTorch chain, in chunks of planes (its int32 temporaries)."""
    from hipe_tpu_torch.ops.blur import filter_chain

    return torch.cat([filter_chain(x[i:i + PLAIN_CHUNK], names, h_axis=-2, w_axis=-1,
                                   h_pad=h_pad)
                      for i in range(0, x.shape[0], PLAIN_CHUNK)])


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return max(int((a[i:i + PLAIN_CHUNK].int() - b[i:i + PLAIN_CHUNK].int()).abs().max())
               for i in range(0, a.shape[0], PLAIN_CHUNK))


def phase_kernel_vs_plain(card: str) -> int:
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda, out_rows
    from hipe_tpu_torch.runtime.device_stream import ROWS_PER_BLOCK_CANDIDATES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    before = gaussian_blur_planar_cuda.launches
    cases = [((NUM_IMAGES * CHANNELS, SIDE, SIDE), 1, h_pad) for h_pad in (True, False)]
    cases += [(shape, r, h_pad) for shape in SMALL_SHAPES for r in (1, 2, 3, 4)
              for h_pad in (True, False) if h_pad or shape[1] > 2 * r]
    worst, checked = 0, 0
    for shape, r, h_pad in cases:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        want = plain_chunked(x, (f"gaussian{2 * r + 1}",), h_pad)
        ho = out_rows(shape[1], r, h_pad)
        for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, ho}):
            got = gaussian_blur_planar_cuda(x, r, h_pad=h_pad, rows_per_block=rpb)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"K1 != plain: shape {shape} r={r} h_pad={h_pad} "
                                     f"rows_per_block={rpb}: max-abs {err}")
            worst, checked = max(worst, err), checked + 1
        del x, want, got
    grew = gaussian_blur_planar_cuda.launches - before
    if grew != checked:
        raise AssertionError(f"launch counter grew by {grew}, expected {checked}")
    print(f"[3 K1 vs plain] {checked} launches over {len(cases)} (shape, radius, "
          f"h_pad) cases, max_abs_err {worst} [{card}]", flush=True)
    return worst


def chain_kernel_vs_plain(label: str, fn, chains: tuple, seed: int) -> tuple[int, int, int]:
    """Hold a chain kernel (through ``fn``, whose launch count must grow by
    one a launch) against the plain chain: ``chains`` on the small shapes
    and the first of them on the full stream, clamp and valid, every
    ``rows_per_block``. Returns (max-abs error, launches, cases)."""
    from hipe_tpu_torch.ops.blur import chain_radius
    from hipe_tpu_torch.runtime.device_stream import ROWS_PER_BLOCK_CANDIDATES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    before = fn.launches
    chain = chains[0]
    cases = [((NUM_IMAGES * CHANNELS, SIDE, SIDE), chain, h_pad) for h_pad in (True, False)]
    cases += [(shape, names, h_pad) for shape in SMALL_SHAPES for names in chains
              for h_pad in (True, False) if h_pad or shape[1] > 2 * chain_radius(names)]
    worst, checked = 0, 0
    for shape, names, h_pad in cases:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        want = plain_chunked(x, names, h_pad)
        for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, want.shape[1]}):
            got = fn(x, names, h_pad=h_pad, rows_per_block=rpb)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"{label} != plain: shape {shape} {names} "
                                     f"h_pad={h_pad} rows_per_block={rpb}: max-abs {err}")
            worst, checked = max(worst, err), checked + 1
        del x, want, got
    grew = fn.launches - before
    if grew != checked:
        raise AssertionError(f"{label} launch counter grew by {grew}, expected {checked}")
    return worst, checked, len(cases)


def phase_k2_vs_plain(card: str) -> int:
    from hipe_tpu_torch.ops.blur import brightness_lut, register_lut_filter
    from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda

    register_lut_filter(LUT_NAME, brightness_lut(0.7))
    worst, checked, n_cases = chain_kernel_vs_plain("K2", filter_chain_planar_cuda,
                                                    K2_CHAINS, seed=1)
    print(f"[4 K2 vs plain] {checked} launches over {n_cases} (shape, chain, "
          f"h_pad) cases, max_abs_err {worst} [{card}]", flush=True)
    return worst


def phase_k3_vs_plain(card: str) -> int:
    from hipe_tpu_torch.ops.blur import register_kernel_filter, register_rank_filter
    from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda

    register_rank_filter(RANK_NAME, 5, 6)
    register_kernel_filter(KERNEL_NAME, range(-12, 13), 7, 2.5)
    worst, checked, n_cases = chain_kernel_vs_plain("K3", rank_chain_planar_cuda,
                                                    K3_CHAINS, seed=2)
    print(f"[5 K3 vs plain] {checked} launches over {n_cases} (shape, chain, "
          f"h_pad) cases, max_abs_err {worst} [{card}]", flush=True)
    return worst


def cuda_ms(fn, reps: int = 1) -> float:
    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_main_path(card: str, phase: str, pipeline: str) -> dict:
    """Drive one pipeline's 5000-image stream; the launch counts over it alone."""
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda
    from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda, is_band_chain
    from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

    wrappers = {"K1": gaussian_blur_planar_cuda, "K2": filter_chain_planar_cuda,
                "K3": rank_chain_planar_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    runner = DeviceStreamRunner(pipeline, num_images=NUM_IMAGES, device="cuda")
    timings = runner.autotune()
    err = runner.verify_max_abs_err()
    sessions = [runner.measure_throughput(passes=PASSES, reps=3)
                for _ in range(SESSIONS)]
    counts = {k: fn.launches for k, fn in wrappers.items()}
    names = runner.pipeline.filters
    kernel = ("K1" if runner.pipeline.single_gaussian
              else "K2" if is_band_chain(names) else "K3")
    if err != 0:
        raise AssertionError(f"{pipeline} main path max_abs_err {err}")
    timed = SESSIONS * 3 * PASSES
    if counts[kernel] < timed:
        raise AssertionError(f"{kernel} launched {counts[kernel]} times on the {pipeline} "
                             f"main path, fewer than the {timed} passes timed")
    for other, n in counts.items():
        if other != kernel and n:
            raise AssertionError(f"{other} launched {n} times on the {pipeline} "
                                 "main path, which is not its kernel's")
    # The stream after 3 chained passes, against the plain version's.
    got = runner.run_passes(3)
    want = runner.stream
    for _ in range(3):
        want = plain_chunked(want, names)
    chain_err = max_abs_err(got, want)
    if chain_err:
        raise AssertionError(f"3 chained {pipeline} passes differ from the plain "
                             f"version: {chain_err}")
    del want
    plain_ms = cuda_ms(lambda: plain_chunked(runner.stream, names))
    by_rate = sorted(sessions, key=lambda s: s["img_per_s"])
    med = by_rate[len(by_rate) // 2]
    print(f"[{phase} main path] {pipeline} {names} {NUM_IMAGES}x{SIDE}x{SIDE}x{CHANNELS}: "
          f"autotune { {k: round(v * 1e3, 4) for k, v in timings.items()} } ms/pass, "
          f"chose {runner.tuning['chosen']}; max_abs_err {err}; sessions img/s "
          f"{[round(s['img_per_s'], 1) for s in by_rate]}; median per-pass "
          f"{med['per_pass_s'] * 1e3:.4f} ms, {med['img_per_s']:.1f} img/s, "
          f"{med['gb_per_s']:.1f} GB/s; plain per-pass {plain_ms:.4f} ms; "
          f"{kernel} launches {counts[kernel]} [{card}]", flush=True)
    del runner, got
    torch.cuda.empty_cache()
    return {"launches": counts[kernel], "ms": med["per_pass_s"] * 1e3,
            "plain_ms": plain_ms, "chain_err": chain_err}


def main() -> int:
    card = phase_env()
    phase_build(card)
    k1_err = phase_kernel_vs_plain(card)
    k2_err = phase_k2_vs_plain(card)
    k3_err = phase_k3_vs_plain(card)
    blur3 = phase_main_path(card, "6", "blur3")
    chain = phase_main_path(card, "7", "chain")
    denoise = phase_main_path(card, "8", "denoise")
    print(json.dumps({"kernels": [{
        "name": "blur_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/blur_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:109",
        "also_replaces": ["hipe_tpu/ops/pallas_blur.py:56",
                          "hipe_tpu/ops/pallas_blur.py:923 (single-gaussian chains)"],
        "launches": blur3["launches"],
        "max_abs_err": max(k1_err, blur3["chain_err"]),
        "ms": blur3["ms"],
        "plain_ms": blur3["plain_ms"],
    }, {
        "name": "chain_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/chain_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:923",
        "launches": chain["launches"],
        "max_abs_err": max(k2_err, chain["chain_err"]),
        "ms": chain["ms"],
        "plain_ms": chain["plain_ms"],
    }, {
        "name": "rank_chain_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/rank_chain_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:273",
        "launches": denoise["launches"],
        "max_abs_err": max(k3_err, denoise["chain_err"]),
        "ms": denoise["ms"],
        "plain_ms": denoise["plain_ms"],
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
