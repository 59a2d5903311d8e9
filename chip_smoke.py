#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each:

1. Environment: torch, CUDA, nvcc, Triton, whether libjpeg (``jpeglib.h``
   and the library) is on the machine, and the card's name and power limit.
   Fails unless ``torch.cuda.is_available()``; never runs on the CPU.
2. Builds kernels K1 (``hipe_tpu_torch/csrc/blur_planar.cu``), K2
   (``hipe_tpu_torch/csrc/chain_planar.cu``), K3
   (``hipe_tpu_torch/csrc/rank_chain_planar.cu``), K4
   (``hipe_tpu_torch/csrc/tiled_blur_planar.cu``), K5
   (``hipe_tpu_torch/csrc/tiled_stage_planar.cu``), K6 and K7
   (``hipe_tpu_torch/csrc/dct_blocks.cu``), K8-K10
   (``hipe_tpu_torch/csrc/equalize_planar.cu``) and K11
   (``hipe_tpu_torch/csrc/ycc_rows.cu``) from the checkout's sources, one
   ``nvcc`` a source, all at once; prints the ptxas report (registers,
   spills, stack frame) of K1's 32 instantiations (radius 1-4 by C = 1-4 or
   any, the run form and, where r*C <= 8, the pairs form), K2's planar
   kernel, K3's four instantiations, K4's four (radius 1-4) and K5's
   seventeen (a stage kind and window each), and fails if K1, K4 or K5
   spills or keeps a stack frame, or K2 or K3 spills.
3. Holds K1 against its plain PyTorch version on distinct random planes:
   radius 1-4, clamp and valid modes, ragged shapes (widths 1-5, 7, 40, 53,
   255, 257, 320, 2100), each also with input and output at storage offset 1
   (unaligned rows: the run form), one full-stream pass, and every
   ``rows_per_block`` the autotune sweeps. Max-abs error must be 0.
4. Holds K2 against its plain PyTorch chain the same way: band and point
   chains (a registered LUT among them, 32 gaussian9 stages whose halo is
   16 times an 8-row tile), clamp and valid modes, ragged shapes, each also
   with input and output at storage offset 1, the full stream for
   ``chain``, every ``rows_per_block`` whose tile fits shared memory.
5. Holds K3 against its plain PyTorch chain the same way: rank-family and
   registered-kernel chains (median, erode/dilate, median5/7/9, ``pil_*``
   presets, a registered rank, kernel and LUT, a median and 31 gaussian9
   stages), clamp and valid modes, ragged shapes and offsets, the full
   stream for ``denoise``, every ``rows_per_block`` that fits.
6. The blur3 main path: the 5000-image 256x256x3 stream through
   ``DeviceStreamRunner`` (autotune, verify against the NumPy oracle, three
   throughput sessions), with the launch counts taken over that run alone;
   its bound and the device's idle share (torch.profiler) over 10 passes;
   beside it a ``Tensor.copy_`` of the stream, a yardstick the port never
   calls. Then K1 alone over the benchmark's 15000x240x320 stream (made by
   ``torch_bench/gen/photo_like.py``): ms a launch at every
   ``rows_per_block`` the autotune sweeps, the fastest kept, beside a
   ``Tensor.copy_`` of that stream, and its output against the plain blur's;
   its warps and live lanes as the launch lays them out (host arithmetic).
7. The chain main path (blur->sharpen->edge), the same way, verified
   against the pipeline's plain path.
8. The denoise main path (median -> gaussian3), the same way.
Each main path also compares the stream after 3 chained passes with the
plain version's and times the plain version's pass for the record; only the
path's own kernel may run on it (K1 blur3, K2 chain, K3 denoise).

9. Holds K1's rows entry against the plain rows blur: C in {1, 2, 3, 4, 5,
   8, 9} (r*C beyond one run among them), radius 1-4, clamp and valid,
   ragged shapes (widths 1, 53, 255, 257, 320 and 768 pixels), each also at
   storage offset 1, every ``rows_per_block``, and the full
   ``(5000, 256, 768)`` rows stream.
10. Holds K2's rows entry against the plain rows chain the same way, for
    C in {1, 3, 4} on widths 1, 53 and 320 pixels, the full rows stream for
    ``chain``; for the record, ``chain`` through the rows
    entry over the full rows stream, timed beside its plain version.
11. Holds K4 against the plain blur: radius 1-4, clamp and valid, planes of
    ``(3, 2250, 4000)`` and ragged shapes (tiles smaller than the plane in
    both axes, H or W below 2r+1, widths that are no multiple of 8 or 16),
    each also with input and output at storage offset 1, every tile shape
    the autotune sweeps, odd tiles (narrower than a run among them), a
    full-width strip and a tile wider than the plane; for the record, K4's
    blur3 over the 5000-image planar stream, to set beside K1's (phase 6).
12. Holds K5 against the plain stage the same way, for every stage kind
    (sharpen, edge, point stages and a LUT, median, erode, dilate, ranks of
    size 5/7/9 and a registered one, ``pil_*`` and a registered kernel).
13. The rows main path: blur3 over the resident 5000-image rows stream
    ``(5000, 256, 768)`` through ``Pipeline.apply_rows`` (a sweep of
    ``rows_per_block``, three timing sessions, the first image against the
    NumPy oracle, 3 chained passes against the plain rows version); only
    K1's rows entry may launch. Beside it a ``Tensor.copy_`` of the rows.
14. The large-frame main paths: ``DeviceStreamRunner`` over 100 frames of
    ``checker_image(2250, 4000, 3, seed=0)`` (2.7 GB) for ``chain`` (K4,
    K5, K5 a pass: too wide for K2) and ``blur3`` (K1, which has no width
    limit): autotune of the tile shape or band height, verify, three
    sessions, the device's idle share (torch.profiler), 3 chained passes
    against the plain chain; only the route's kernels may launch. The
    kernels' own times are taken at the chosen knob (and, for K4 and K5,
    at the swept tile that suits each best). Beside them, for the record,
    the other route: K2 at the tallest tile that fits for the chain, K4 at
    every swept tile for blur3 (the faster of K1 and K4 runs it). And as
    yardsticks the port never calls: a ``Tensor.copy_`` of the 2.7 GB
    stream (the bandwidth a kernel that reads and writes it once can
    reach), and ``torch.bitwise_not`` and ``torch.bitwise_and`` over it,
    the one-call counterparts of K5's invert and posterize4, beside K5's
    own times for those two stages.

15. The codec's build: the ptxas report of K6 and K7 (``dct_blocks.cu``)
    and of K11's four kernels (``ycc_rows.cu``: the aligned and the any
    form, each upsampling or not), built in phase 2 with the rest:
    registers, spills, stack frame, barriers, shared memory; fails if K7
    spills or keeps a stack frame.
16. Holds K6 (dequantize + IDCT) against its plain PyTorch version:
    distinct random coefficients over the full int16 range (+-32767 among
    them) and over [-2048, 2048), random 8-bit and 16-bit quant tables,
    block grids (1,1) to (282,500) (the luma of a 4000x2250 frame) in
    batches of 1-8, and the main path's 5000-image grids. Max-abs must be 0.
17. Holds K7 (fDCT + quantize) against its plain version the same way, on
    random uint8 grids, grids of flat 0 and 255 blocks, and grids of the
    blocks that reach each coefficient's extremes (samples 0 or 255 by the
    signs of its DCT basis; the DC's are the flat blocks, |t| = 8192 before
    quantizing), with ``quality_tables(q)`` for q in {1, 50, 75, 90, 100},
    tables of 1 and of 65535 at every position, and random 8- and 16-bit
    tables; int16 outputs must be equal.
18. The codec main paths over the device-resident coefficient stream: the
    4:2:0 quality-90 coefficients of ``checker_image(256, 256, 3, seed=0)``
    in 5000 distinct per-image buffers (983 MB of int16). Encode (pixels
    ``(5000, 256, 768)`` -> coefficients), decode (-> rows), decode + blur3
    (``Pipeline.apply_rows``) and the transcode (decode -> blur3 -> encode
    through ``ServingPipeline.transcode_fn``, passes chained): per-pass ms
    (3 sessions), the result against the plain path on the card (after 3
    chained passes for the transcode), the first image against the port's
    CPU path, the device idle share; only K6, K11 (upsample + colour), K7
    and K1's rows entry may launch, each exactly as often a pass as the
    path needs (a transcode pass: 3, 1, 1, 3; the ``kernels`` line's
    ``launches_per_pass`` of K6, K7 and K11 are these counts over the
    transcode's passes). K6's, K11's, K1's and K7's own times and that of
    the torch colour + downsample split a transcode pass. Then K11 alone
    over grids of the codec cell's shapes (5000 images of 320x240 4:2:0:
    luma (240, 320), chroma 2 x (120, 160)), in its aligned form; over the
    same grids at bases one byte off, and at the cell's 1/8 decode (40x30),
    in its any form (the form each call took is read from the kernel names
    torch.profiler records): ms a launch beside its bound (the bytes over
    3.35 TB/s), a ``Tensor.copy_`` moving as many bytes, its plain
    version's ms, and max_abs_err 0 against it.
The byte-level serving round trip needs libjpeg for the host entropy layer;
the card's machine has none (no ``jpeglib.h``, no ``libjpeg.so``), so it is
driven only where phase 1 finds it (phase 20).

19. The reference's programs: the heterogeneous engine
    (``runtime/engine.py``, ``runtime/fleet.py``) over a host-CPU lane (the
    plain PyTorch rows chain) and the card, on the reference's stream of
    5000 images of 320x240x3 (1.15 GB): the first 500 distinct random
    images (seeded), the rest replicated. (a) approach 1 ``gpu`` at batch
    500 and 35; (b) approach 1 ``both`` at ratio 0.5, then at the ratio
    ``calibrate_ratio`` finds on 300 images; (c) approach 1 ``both`` with
    the greedy scheduler; (d) approach 2 (blur3) at 0.5 and at its
    calibrated ratio; (e) approach 2 ``chain`` at batch 35 (K2 after the
    relayout); (f) a two-lane ``FleetEngine`` (cpu, cuda:0), greedy, over
    1000 images. A line a run: wall ms and img/s, each lane's images and
    in/kernel/out ms, the imbalance, the launches over that run alone
    (K1's rows entry for blur3, K2 for chain, one a CUDA-lane batch and
    one a warm-up shape; no other kernel), and batch 0 against the plain
    chain on the card (held against the NumPy oracle on 100 images),
    seams included: max_abs_err must be 0. For the record, one 115 MB
    batch to the card and back through new pageable memory and through
    reused pinned memory (the CUDA lane's staging), and the phase's seconds.
20. The serving options over phase 18's stream (5000 resident 4:2:0 q90
    coefficient sets): ``ServingPipeline.decode_filter_fn`` and
    ``transcode_fn`` (blur3) with ``decode_scale`` 2, 4 and 8,
    ``decode_gray``, ``gray_output``, ``output_scale=2``,
    ``resize_to=(144, 200)`` and ``decode_gray`` with a ``colorize`` table
    from hex colours; the decode of 1000 CMYK and 1000 YCCK coefficient
    sets K7 makes from four planes; the seven lossless transforms over the
    stream. A line a path: ms a pass (CUDA events), the K6, K11, K7 and K1
    rows-entry launches over its passes alone (exactly those its options
    need: K6 a component whose scaled DCT size is 8, K11 one where
    ``ycc_rows_fancy`` takes the decode, K7 an output component, K1 one;
    the transforms none), max_abs_err against the same
    path with each kernel replaced by its plain version on the card, and
    its first 16 images against the same path on CPU tensors (the reduced
    IDCTs and the transforms among them): both must be 0. Where phase 1
    finds libjpeg, also a byte-level ``serve --decode-scale 4 --gray`` and a
    ``transform`` rot90/rot270 round trip; elsewhere a line says why not.
    Then the phase's seconds.

21. The global-statistics family (``GlobalStatsPipeline``; PyTorch ops, as
    they are XLA ops in ``hipe_tpu``, but for equalize's three hand-written
    kernels K8-K10 and the mode filters' K12): ``DeviceStreamRunner`` over
    the 5000-image stream for equalize, autocontrast (plain, ``cutoff=2``,
    ``preserve_tone``), contrast 1.5, color 2.2, sharpness 2.0, mode and
    mode5: ms a pass (CUDA events), its bound (the bytes a pass must move),
    peak device memory, the device's idle share over at least 100 ms of
    passes, the first image against the NumPy oracle and the first 16 of a kept pass
    against the same op on CPU tensors; sharpness's K3 launches (one a chunk
    of a pass) and a pass with K3 swapped for its plain version; equalize's
    K8, K9 and K10 launches and mode's and mode5's K12 launches (one each a
    pass, the stream one chunk); K8-K10 each alone over the stream and over
    the benchmark's 15000x240x320 stream, and K12 at both sizes alone over
    the latter (its ptxas report too; a spill or a stack frame fails): ms a
    launch, its bound by bytes, its plain version's ms on the card and its
    output against the plain version's; no other op launches a kernel. 64
    varied 256x256 images
    (the kinds of ``tests/test_equalize.py``, quantized levels, the float64
    quirk) against the NumPy oracles on each path (for mode and mode5, whose
    oracle is slow, a plane of one image of each kind, and all 64 against
    the CPU). The engine: approach 1
    ``gpu`` at batch 500 with equalize over phase 19's stream (K8-K10 a
    CUDA-lane batch), batch 0 against the oracle. Serving:
    ``decode_filter_fn`` and ``transcode_fn`` with equalize, autocontrast
    ``cutoff=2`` and contrast 1.5 over phase 18's coefficient stream, as
    phase 20 drives its paths (K6, K7; K8-K10 for equalize). Every
    max_abs_err must be 0. Then the phase's seconds.

Then one JSON line of per-kernel results (each kernel's launches on its
main path, its worst error against the plain version, its time and the
plain version's a pass, and its bound: the larger of the bytes it must move
over the card's 3.35 TB/s and the operations it must do on its uint8 inputs
over the card's int8 peak, or for K6 and K7 their int32 operations over the
CUDA cores' int32 rate), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NUM_IMAGES = 5000
SIDE = 256
CHANNELS = 3
PASSES = 10
SESSIONS = 3
# Pixels per call of the plain version on the card (1000 planes of 256x256,
# 7 of 4000x2250): its int32 temporaries for the whole (15000, 256, 256)
# stream would be ~3.9 GB each.
PLAIN_CHUNK_PIXELS = 1000 * 256 * 256
# Widths 1-5, 7, 40, 53, 255, 257, 320, 2100; 300 rows for a 32-stage
# chain's valid mode. K2 and K3 also take each at storage offset 1.
SMALL_SHAPES = ((6, 240, 320), (5, 37, 53), (3, 1, 7), (2, 9, 1), (1, 13, 2), (1, 11, 3),
                (1, 12, 4), (1, 10, 5), (2, 20, 255), (2, 21, 257), (2, 300, 40),
                (2, 9, 2100))
# (B, H, W pixels); 255, 257 and 768 pixels are several of K1's warps of 32
# runs a row at any C; in the others a warp spans images at some C.
ROWS_SHAPES = ((4, 240, 320), (3, 37, 53), (2, 9, 1), (2, 20, 255), (2, 21, 257),
               (1, 19, 768))
# K1's rows entry: C = 1-4 (its pairs form where r*C <= 8, the run form
# beyond: C = 3 and 4 at r = 3, 4) and C = 5, 8, 9 (C known only at run
# time: the run form).
K1_ROWS_CHANNELS = (1, 2, 3, 4, 5, 8, 9)
LARGE_H, LARGE_W, LARGE_FRAMES = 2250, 4000, 100
# Widths 4000, 1100, 700 and 3 are no multiple of 16, 1100 and 700 no
# multiple of 8; 257 and 4001 odd. K4 and K5 also take each at storage
# offset 1.
TILED_SHAPES = ((3, LARGE_H, LARGE_W), (2, 131, 1100), (3, 2, 700), (2, 150, 3),
                (1, 1, 1), (2, 37, 257), (1, 40, 4001))
# Besides the autotune's tile shapes: odd tiles, two narrower than a run of
# 8; a full-width strip (0: the plane's width) and a tile wider than any
# plane.
EXTRA_TILES = ((3, 5), (5, 7), (4, 4), (16, 0), (8, 8192))
# The card's peaks (data sheet; H100 SXM, dense): device memory, and
# operations on 8-bit integers, the type of every kernel's inputs.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# int32 operations on the CUDA cores: 64 lanes an SM, 132 SMs, 1.98 GHz,
# and at most two operations an instruction (a multiply-add, a three-input
# add, a shift-and-add), as the data sheet counts a multiply-add as two.
# K6's and K7's products exceed 24 bits, so no tensor-core peak applies.
INT32_OPS_PER_S = 2 * 64 * 132 * 1.98e9
# int32 operations a sample, counted by hand from the code (a multiply, an
# add, a shift, a compare, a select, an abs, a byte permute: one each;
# DESCALE two): an 8-point IDCT pass 62 for 8 samples, an 8-point fDCT pass
# 58 (row) and 60 (column). K6: dequantize 1 + two passes 15.5 + the range
# limit 9 (and, three compares, three selects, two adds). K7: the byte's
# extract 1 + two passes 14.75 + the level shift 1/64 (one subtract a
# block, from its DC) + the quantizer 7 (abs, add, multiply-high, shift,
# compare, negate, select; no divide) + 1/2 to pack two coefficients a word.
K6_OPS_PER_SAMPLE = 1 + 2 * 62 / 8 + 9
K7_OPS_PER_SAMPLE = 1 + (58 + 60) / 8 + 1 / 64 + 7 + 1 / 2
DCT_GRIDS = ((1, 1), (5, 7), (4, 16), (32, 32), (16, 16), (282, 500))  # (Hb, Wb)
QUALITIES = (1, 50, 75, 90, 100)
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
    ("gaussian9",) * 32,  # total radius 128: a halo 16 times an 8-row tile
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
    ("median",) + ("gaussian9",) * 31,
)
K5_STAGES = ("sharpen", "edge", "invert", "solarize", "posterize4", LUT_NAME, "median",
             "erode", "dilate", "median5", RANK_NAME, "median7", "median9", "pil_emboss",
             "pil_smooth_more", KERNEL_NAME)


def _run(cmd: list[str]) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    lines = (proc.stdout.strip() or proc.stderr.strip() or "no output").splitlines()
    return next((ln for ln in lines if "release" in ln), lines[-1])


def libjpeg_found() -> str:
    """Whether the compiler finds ``jpeglib.h`` and the linker ``libjpeg``,
    which the host entropy layer of the JPEG codec needs."""
    import ctypes.util

    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True, timeout=60)
        header = "found" if proc.returncode == 0 else "absent"
    except (OSError, subprocess.TimeoutExpired) as e:
        header = f"unknown ({type(e).__name__})"
    return f"jpeglib.h {header}, libjpeg {ctypes.util.find_library('jpeg') or 'absent'}"


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
          f"nvcc '{nvcc}' triton {triton_version} {libjpeg_found()} card '{card}'",
          flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: chip_smoke.py "
                         "runs only on an NVIDIA GPU")
    return card


def phase_build(card: str) -> None:
    import re

    from hipe_tpu_torch.ops import (_build, cuda_blur, cuda_chain, cuda_dct, cuda_rank_chain,
                                    cuda_tiled)

    t0 = time.perf_counter()
    lib = _build.build()
    for wrapper in (cuda_blur.gaussian_blur_planar_cuda, cuda_blur.gaussian_blur_rows_cuda,
                    cuda_chain.filter_chain_planar_cuda, cuda_chain.filter_chain_rows_cuda,
                    cuda_rank_chain.rank_chain_planar_cuda,
                    cuda_tiled.gaussian_blur_planar_tiled_cuda,
                    cuda_tiled.filter_stage_planar_tiled_cuda, cuda_dct.dequant_idct_cuda,
                    cuda_dct.fdct_quantize_cuda):
        wrapper.launch.bind()
    secs = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text() if (lib.parent / "build.log").exists() else ""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
    ptxas = (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, "
             f"{spills} bytes of spill stores in all" if regs else "no report")
    print(f"[2 build] {lib} in {secs:.2f} s (0 s: already built); ptxas: {ptxas} "
          f"(full report: build.log beside it) [{card}]", flush=True)
    # K2's planar kernel and K3's four instantiations (widest window 3-9).
    report = []
    for entry in log.split("Compiling entry function")[1:]:
        head = entry.split("\n")[0]
        name = re.search(r"chain_lanes_kernel|rank_chain_planar_u8_kernelILi(\d)E", head)
        if name:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            label = f"K3<{name.group(1)}>" if name.group(1) else "K2 planar"
            report.append((label, int(regs.group(1)) if regs else -1,
                           int(spill.group(1)) if spill else -1))
    if len(report) != 5 or any(sp != 0 for _, _, sp in report):
        raise AssertionError(f"ptxas report of K2 and K3 missing, or spills: {report}")
    print(f"[2 build] K2/K3 ptxas: " + "; ".join(
        f"{label} {regs} registers, {sp} B spill stores" for label, regs, sp in report)
        + f" [{card}]", flush=True)
    k1 = k1_ptxas(log)
    bad = [t for t in k1 if t[2] != 0 or t[3] != 0 or t[4] != 0]
    if len(k1) != K1_INSTANTIATIONS or bad:
        raise AssertionError(f"ptxas report of K1 missing (found {len(k1)} of "
                             f"{K1_INSTANTIATIONS}), or spills or a stack frame: {bad or k1}")
    print(f"[2 build] K1 ptxas (registers, spill stores, spill loads, stack frame; r, C, "
          f"form): " + "; ".join(f"{label} {regs}/{st}/{ld}/{frame}"
                                 for label, regs, st, ld, frame in k1) + f" [{card}]",
          flush=True)
    tiled = tiled_ptxas(log)
    bad = [t for t in tiled if t[2] != 0 or t[3] != 0 or t[4] != 0]
    if len(tiled) != 21 or bad:
        raise AssertionError(f"ptxas report of K4 and K5 missing (found {len(tiled)} of 21), "
                             f"or spills or a stack frame: {bad or tiled}")
    print(f"[2 build] K4/K5 ptxas (registers, spill stores, spill loads, stack frame): "
          + "; ".join(f"{label} {regs}/{st}/{ld}/{frame}"
                      for label, regs, st, ld, frame in tiled) + f" [{card}]", flush=True)


# K1's instantiations: the run form for radius 1-4 and C = 1-4 or any (0),
# and the pairs form where r*C <= 8 for C = 1-4 (12 of them).
K1_INSTANTIATIONS = 4 * 5 + sum(1 for r in range(1, 5) for c in range(1, 5) if r * c <= 8)


def ptxas_numbers(entry: str) -> tuple[int, int, int, int]:
    """(registers, spill store bytes, spill load bytes, stack frame bytes) of
    one entry function's ptxas report; -1 where the report lacks one."""
    import re

    def num(pattern: str) -> int:
        m = re.search(pattern, entry)
        return int(m.group(1)) if m else -1

    return (num(r"Used (\d+) registers"), num(r"(\d+) bytes spill stores"),
            num(r"(\d+) bytes spill loads"), num(r"(\d+) bytes stack frame"))


def k1_ptxas(log: str) -> list:
    """(label, registers, spill store bytes, spill load bytes, stack frame
    bytes) of each K1 instantiation (blur_u8_kernel<R, C, pairs form>)."""
    import re

    out = []
    for entry in log.split("Compiling entry function")[1:]:
        m = re.search(r"\d+blur_u8_kernelILi(\d)ELi(\d)ELb(\d)E", entry.split("\n")[0])
        if m:
            form = "pairs" if m.group(3) == "1" else "runs"
            out.append((f"r{m.group(1)} C{m.group(2) if m.group(2) != '0' else 'any'} {form}",
                        *ptxas_numbers(entry)))
    return sorted(out)


# chain_stages.cuh's Op codes, for the names of K5's instantiations.
OP_NAMES = {1: "sharpen", 2: "edge", 3: "invert", 4: "solarize", 5: "posterize", 6: "lut",
            7: "median", 8: "erode", 9: "dilate", 10: "rank", 11: "kernel"}


def tiled_ptxas(log: str) -> list:
    """(label, registers, spill store bytes, spill load bytes, stack frame
    bytes) of each K4 and K5 instantiation in the build log."""
    import re

    out = []
    for entry in log.split("Compiling entry function")[1:]:
        head = entry.split("\n")[0]
        k5 = re.search(r"tiled_(?:stage|window)_u8_kernelILi(\d+)ELi(\d+)ELi(\d+)E", head)
        k4 = re.search(r"tiled_blur_u8_kernelILi(\d)E", head)
        if not (k4 or k5):
            continue
        label = (f"K4 r{k4.group(1)}" if k4 else
                 f"K5 {OP_NAMES.get(int(k5.group(1)), k5.group(1))}{k5.group(2)}")
        out.append((label, *ptxas_numbers(entry)))
    return sorted(out)


def _chunk(x: torch.Tensor) -> int:
    """Planes (or images) a call of at most PLAIN_CHUNK_PIXELS elements."""
    return max(1, PLAIN_CHUNK_PIXELS // max(1, x[0].numel()))


def plain_chunked(x: torch.Tensor, names: tuple, h_pad: bool = True) -> torch.Tensor:
    """The plain PyTorch chain, in chunks of planes (its int32 temporaries)."""
    from hipe_tpu_torch.ops.blur import filter_chain

    k = _chunk(x)
    return torch.cat([filter_chain(x[i:i + k], names, h_axis=-2, w_axis=-1, h_pad=h_pad)
                      for i in range(0, x.shape[0], k)])


def plain_rows_chunked(x: torch.Tensor, channels: int, names: tuple,
                       h_pad: bool = True) -> torch.Tensor:
    """The plain PyTorch rows chain, in chunks of images."""
    from hipe_tpu_torch.ops.blur import filter_chain_rows

    k = _chunk(x)
    return torch.cat([filter_chain_rows(x[i:i + k], channels, names, h_pad=h_pad)
                      for i in range(0, x.shape[0], k)])


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    k = _chunk(a)
    return max(int((a[i:i + k].int() - b[i:i + k].int()).abs().max())
               for i in range(0, a.shape[0], k))


def stage_ops(name: str) -> int:
    """Integer operations one output pixel of a stage takes, a multiply-add
    counted as two (as the card's peak counts them): a gaussian 2(2r+1)
    multiply-adds and a shift; sharpen 5 multiply-adds and a clamp (2); edge
    two gradients of 6 multiply-adds, two abs, an add and a min; the 3x3
    median Paeth's 19 min/max; erode and dilate 8; a size-n rank 8 rounds of
    n^2 compares and n^2 adds (the count the data needs: always all 8); a
    size-n kernel n^2 multiply-adds, the divide and clamp; a point stage 1."""
    from hipe_tpu_torch.ops import blur as tblur

    if name in tblur.GAUSSIANS:
        return 8 * tblur.FILTER_RADIUS[name] + 5
    if name in tblur.RANK_STAGES:
        return 16 * tblur.RANK_STAGES[name][0] ** 2 + 8
    if name in tblur.KERNEL_STAGES:
        return 2 * tblur.KERNEL_STAGES[name]["size"] ** 2 + 4
    return {"sharpen": 12, "edge": 28, "median": 19, "erode": 8, "dilate": 8}.get(name, 1)


def bound(launch_bytes: int, names: tuple, pixels: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time for launches that move
    ``launch_bytes`` (each input read once, each output written once) and
    run the stages ``names`` over ``pixels`` output pixels."""
    t_bytes = launch_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(stage_ops(nm) for nm in names) * pixels / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts() -> dict:
    """Every kernel wrapper's launch counter, set to 0: {label: wrapper}."""
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda, gaussian_blur_rows_cuda
    from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda, filter_chain_rows_cuda
    from hipe_tpu_torch.ops.cuda_dct import dequant_idct_cuda, fdct_quantize_cuda, ycc_rows_cuda
    from hipe_tpu_torch.ops.cuda_equalize import (apply_lut_planar_cuda, equalize_lut_cuda,
                                                  histogram_planes_cuda)
    from hipe_tpu_torch.ops.cuda_mode import mode_planar_cuda
    from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
    from hipe_tpu_torch.ops.cuda_tiled import (filter_stage_planar_tiled_cuda,
                                               gaussian_blur_planar_tiled_cuda)

    wrappers = {"K1": gaussian_blur_planar_cuda, "K1 rows": gaussian_blur_rows_cuda,
                "K2": filter_chain_planar_cuda, "K2 rows": filter_chain_rows_cuda,
                "K3": rank_chain_planar_cuda, "K4": gaussian_blur_planar_tiled_cuda,
                "K5": filter_stage_planar_tiled_cuda, "K6": dequant_idct_cuda,
                "K7": fdct_quantize_cuda, "K8": histogram_planes_cuda,
                "K9": equalize_lut_cuda, "K10": apply_lut_planar_cuda, "K11": ycc_rows_cuda,
                "K12": mode_planar_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def check_counts(wrappers: dict, expect: dict, path: str, exact: bool = False) -> dict:
    """The counts since reset_counts; raises unless each kernel in
    ``expect`` launched at least that often (with ``exact``, that often)
    and no other launched."""
    counts = {k: fn.launches for k, fn in wrappers.items()}
    for k, n in counts.items():
        if k in expect and (n != expect[k] if exact else n < expect[k]):
            raise AssertionError(f"{k} launched {n} times on the {path} main path, "
                                 f"{'not' if exact else 'fewer than'} the {expect[k]} "
                                 "its passes take")
        if k not in expect and n:
            raise AssertionError(f"{k} launched {n} times on the {path} main path, "
                                 "which is not its kernel's")
    return counts


def phase_kernel_vs_plain(card: str) -> int:
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda, out_rows
    from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    before = gaussian_blur_planar_cuda.launches
    cases = [((NUM_IMAGES * CHANNELS, SIDE, SIDE), 1, h_pad, 0) for h_pad in (True, False)]
    cases += [(shape, r, h_pad, offset) for shape in SMALL_SHAPES for r in (1, 2, 3, 4)
              for h_pad in (True, False) for offset in (0, 1) if h_pad or shape[1] > 2 * r]
    worst, checked = 0, 0
    for shape, r, h_pad, offset in cases:
        numel = shape[0] * shape[1] * shape[2]
        x = torch.randint(0, 256, (numel + offset,), dtype=torch.uint8, device=dev,
                          generator=gen)[offset:].view(shape)
        want = plain_chunked(x, (f"gaussian{2 * r + 1}",), h_pad)
        out = torch.empty(want.numel() + offset, dtype=torch.uint8,
                          device=dev)[offset:].view(want.shape)
        ho = out_rows(shape[1], r, h_pad)
        for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, ho}):
            got = gaussian_blur_planar_cuda(x, r, h_pad=h_pad, rows_per_block=rpb, out=out)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"K1 != plain: shape {shape} offset {offset} r={r} "
                                     f"h_pad={h_pad} rows_per_block={rpb}: max-abs {err}")
            worst, checked = max(worst, err), checked + 1
        del x, want, out, got
    grew = gaussian_blur_planar_cuda.launches - before
    if grew != checked:
        raise AssertionError(f"launch counter grew by {grew}, expected {checked}")
    print(f"[3 K1 vs plain] {checked} launches over {len(cases)} (shape, radius, "
          f"h_pad, storage offset) cases, max_abs_err {worst} [{card}]", flush=True)
    return worst


def chain_kernel_vs_plain(label: str, fn, chains: tuple, seed: int) -> tuple[int, int, int]:
    """Hold a chain kernel (through ``fn``, whose launch count must grow by
    one a launch) against the plain chain: ``chains`` on the small shapes,
    each also with input and output at storage offset 1 (unaligned rows),
    and the first of them on the full stream, clamp and valid, every
    ``rows_per_block`` whose tile fits shared memory. Returns (max-abs
    error, launches, cases)."""
    from hipe_tpu_torch.ops.blur import chain_radius
    from hipe_tpu_torch.ops.planar import (ROWS_PER_BLOCK_CANDIDATES, SHARED_BYTES_PER_BLOCK,
                                           fused_shared_bytes)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    before = fn.launches
    chain = chains[0]
    cases = [((NUM_IMAGES * CHANNELS, SIDE, SIDE), chain, h_pad, 0) for h_pad in (True, False)]
    cases += [(shape, names, h_pad, offset) for shape in SMALL_SHAPES for names in chains
              for h_pad in (True, False) for offset in (0, 1)
              if h_pad or shape[1] > 2 * chain_radius(names)]
    worst, checked = 0, 0
    for shape, names, h_pad, offset in cases:
        numel = shape[0] * shape[1] * shape[2]
        x = torch.randint(0, 256, (numel + offset,), dtype=torch.uint8, device=dev,
                          generator=gen)[offset:].view(shape)
        want = plain_chunked(x, names, h_pad)
        out = torch.empty(want.numel() + offset, dtype=torch.uint8,
                          device=dev)[offset:].view(want.shape)
        for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, want.shape[1]}):
            if fused_shared_bytes(min(rpb, want.shape[1]), shape[2], names) > SHARED_BYTES_PER_BLOCK:
                continue  # the launch is refused; the card-only tests hold that
            got = fn(x, names, h_pad=h_pad, rows_per_block=rpb, out=out)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"{label} != plain: shape {shape} offset {offset} "
                                     f"{names[:4]}{'...' if len(names) > 4 else ''} "
                                     f"h_pad={h_pad} rows_per_block={rpb}: max-abs {err}")
            worst, checked = max(worst, err), checked + 1
        del x, want, out
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


def median_pass_ms(fn) -> tuple[float, list[float]]:
    """(median, sorted sessions): SESSIONS sessions, each the mean of 3
    CUDA-event timings of ``fn()`` (which runs PASSES passes), a pass."""
    sessions = sorted(cuda_ms(fn, reps=3) / PASSES for _ in range(SESSIONS))
    return sessions[len(sessions) // 2], sessions


def device_busy(fn) -> tuple[float, float]:
    """(CUDA-event window ms around ``fn()``, kernel ms in it, from the
    kernel times torch.profiler records); raises if it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        raise AssertionError("torch.profiler recorded no kernel time on the card: "
                             "the device's idle share is not measured")
    return start.elapsed_time(end), busy_us / 1e3


def phase_main_path(card: str, phase: str, pipeline: str) -> dict:
    """Drive one pipeline's 5000-image stream; the launch counts over it alone."""
    from hipe_tpu_torch.ops.chain_program import is_band_chain
    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

    wrappers = reset_counts()
    runner = DeviceStreamRunner(pipeline, num_images=NUM_IMAGES, device="cuda")
    timings = runner.autotune()
    err = runner.verify_max_abs_err()
    sessions = [runner.measure_throughput(passes=PASSES, reps=3)
                for _ in range(SESSIONS)]
    names = runner.pipeline.filters
    kernel = ("K1" if runner.pipeline.single_gaussian
              else "K2" if is_band_chain(names) else "K3")
    counts = check_counts(wrappers, {kernel: SESSIONS * 3 * PASSES}, pipeline)
    if err != 0:
        raise AssertionError(f"{pipeline} main path max_abs_err {err}")
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
    # The yardstick the port never calls: a copy of the stream, the rate a
    # kernel that reads and writes it once can reach.
    copy_ms = cuda_ms(lambda: runner._bufs[0].copy_(runner.stream), reps=PASSES)
    busy = device_busy(lambda: runner.run_passes(PASSES))
    bound_ms, bound_by = bound(2 * runner.stream.numel(), names, runner.stream.numel())
    by_rate = sorted(sessions, key=lambda s: s["img_per_s"])
    med = by_rate[len(by_rate) // 2]
    print(f"[{phase} main path] {pipeline} {names} {NUM_IMAGES}x{SIDE}x{SIDE}x{CHANNELS}: "
          f"autotune { {k: round(v * 1e3, 4) for k, v in timings.items()} } ms/pass, "
          f"chose {runner.tuning['chosen']}; max_abs_err {err}; sessions img/s "
          f"{[round(s['img_per_s'], 1) for s in by_rate]}; median per-pass "
          f"{med['per_pass_s'] * 1e3:.4f} ms, {med['img_per_s']:.1f} img/s, "
          f"{med['gb_per_s']:.1f} GB/s; bound {bound_ms:.4f} ms ({bound_by}); device idle "
          f"over {PASSES} passes {1 - busy[1] / busy[0]:.2%} (kernels {busy[1]:.3f} of "
          f"{busy[0]:.3f} ms); plain per-pass {plain_ms:.4f} ms; Tensor.copy_ of the stream "
          f"{copy_ms:.4f} ms; {kernel} launches {counts[kernel]} [{card}]", flush=True)
    del runner, got
    torch.cuda.empty_cache()
    return {"launches": counts[kernel], "ms": med["per_pass_s"] * 1e3,
            "plain_ms": plain_ms, "chain_err": chain_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "idle": 1 - busy[1] / busy[0], "copy_ms": copy_ms}


def sweep_rows_per_block(launch, x: torch.Tensor, out: torch.Tensor) -> dict:
    """ms of ``launch(rows_per_block)`` (CUDA events, the mean of PASSES) at
    each rows_per_block the autotune sweeps, the fastest kept, and of a
    ``Tensor.copy_`` of ``x`` into ``out`` beside it."""
    from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

    times = {rpb: cuda_ms(lambda: launch(rpb), reps=PASSES) for rpb in ROWS_PER_BLOCK_CANDIDATES}
    rpb = min(times, key=times.get)
    return {"ms": times[rpb], "rows_per_block": rpb,
            "all": {k: round(v, 4) for k, v in times.items()},
            "copy_ms": cuda_ms(lambda: out.copy_(x), reps=PASSES)}


def phase_k1_bench_stream(card: str) -> dict:
    """K1 (blur3) alone over the benchmark's (15000, 240, 320) stream: ms a
    launch at each rows_per_block the autotune sweeps beside a copy_ of the
    stream (sweep_rows_per_block); its bound by bytes; its output against
    the plain blur's. The printed lanes are launch_kc's layout worked out
    on the host, not a reading."""
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda

    planes = bench_stream_planes(seed=6)
    n, h, w = planes.shape
    out = torch.empty_like(planes)
    before = gaussian_blur_planar_cuda.launches
    res = sweep_rows_per_block(
        lambda rpb: gaussian_blur_planar_cuda(planes, 1, rows_per_block=rpb, out=out), planes, out)
    rpb = res["rows_per_block"]
    err = max_abs_err(gaussian_blur_planar_cuda(planes, 1, rows_per_block=rpb, out=out),
                      plain_chunked(planes, ("gaussian3",)))
    launches = gaussian_blur_planar_cuda.launches - before
    if err:
        raise AssertionError(f"K1 over the benchmark's stream: max-abs {err} against plain")
    bound_ms = 2 * planes.numel() / HBM_BYTES_PER_S * 1e3
    # launch_kc's layout: the stream's runs of 8 bytes, 32 a warp, a band each.
    runs, bands = n * -(-w // 8), -(-h // min(rpb, h))
    warps = -(-runs // 32) * bands
    print(f"[6 K1 bench stream] blur3 alone over {n}x{h}x{w}: rows_per_block {res['all']} ms a "
          f"launch, chose {rpb}: {res['ms']:.4f} ms, {bound_ms / res['ms']:.2%} of its bound "
          f"{bound_ms:.4f} ms (bytes); Tensor.copy_ of the stream {res['copy_ms']:.4f} ms "
          f"({res['ms'] / res['copy_ms']:.3f}x); launch layout (host arithmetic, not measured): "
          f"{warps} warps, {runs * bands} of {32 * warps} lanes hold a run; max_abs_err {err}; "
          f"{launches} launches [{card}]", flush=True)
    del planes, out
    torch.cuda.empty_cache()
    return {**res, "shape": [n, h, w], "bound_ms": bound_ms, "launches": launches, "err": err}


def check_against(label: str, fn, want: torch.Tensor, what: str) -> int:
    """Launch ``fn()`` once, synchronize, and hold it against ``want``."""
    got = fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{label} != plain: {what}: max-abs {err}")
    return err


def phase_rows_vs_plain(card: str, phase: str, label: str, fn, counter, chains: tuple,
                        seed: int, shapes: tuple = ROWS_SHAPES, channels: tuple = (1, 3, 4),
                        offsets: tuple = (0,), record: bool = False) -> int:
    """Hold a rows entry (``fn(rows, c, names, ...)``, launching through the
    wrapper ``counter``) against the plain rows chain: C in ``channels``,
    ``chains`` on ``shapes``, each at every storage offset of
    ``offsets`` (input and output), and the first of them on the full rows
    stream, clamp and valid, every rows_per_block whose tile fits shared
    memory. With ``record``, also time the first chain over the full rows
    stream at each of those rows_per_block, and its plain version, for the
    record."""
    from hipe_tpu_torch.ops.blur import chain_radius
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_rows_cuda
    from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES, SHARED_BYTES_PER_BLOCK

    def rows_entry_bytes(rows: int, lanes: int, names: tuple) -> int:
        """Shared memory of the rows entry a block: none for K1's, K2's two
        unpadded buffers (its first design)."""
        if counter is gaussian_blur_rows_cuda:
            return 0
        r = chain_radius(names)
        return (rows + 2 * r) * lanes * 2

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    before = counter.launches
    cases = [((NUM_IMAGES, SIDE, SIDE), CHANNELS, chains[0], h_pad, 0)
             for h_pad in (True, False)]
    cases += [(shape, c, names, h_pad, offset) for shape in shapes for c in channels
              for names in chains for h_pad in (True, False) for offset in offsets
              if h_pad or shape[1] > 2 * chain_radius(names)]
    checked = 0
    for (b, h, w), c, names, h_pad, offset in cases:
        numel = b * h * w * c
        x = torch.randint(0, 256, (numel + offset,), dtype=torch.uint8, device=dev,
                          generator=gen)[offset:].view(b, h, w * c)
        want = plain_rows_chunked(x, c, names, h_pad)
        out = torch.empty(want.numel() + offset, dtype=torch.uint8,
                          device=dev)[offset:].view(want.shape)
        for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, want.shape[1]}):
            if rows_entry_bytes(min(rpb, want.shape[1]), w * c, names) > SHARED_BYTES_PER_BLOCK:
                continue  # the launch is refused; the card-only tests hold that
            check_against(label, lambda: fn(x, c, names, h_pad=h_pad, rows_per_block=rpb,
                                            out=out),
                          want, f"rows {(b, h, w * c)} offset {offset} C={c} {names} "
                                f"h_pad={h_pad} rows_per_block={rpb}")
            checked += 1
        del x, want, out
    grew = counter.launches - before
    if grew != checked:
        raise AssertionError(f"{label} launch counter grew by {grew}, expected {checked}")
    note = ""
    if record:
        names = chains[0]
        x = torch.randint(0, 256, (NUM_IMAGES, SIDE, SIDE * CHANNELS), dtype=torch.uint8,
                          device=dev, generator=gen)
        out = torch.empty_like(x)
        times = {rpb: cuda_ms(lambda: fn(x, CHANNELS, names, rows_per_block=rpb, out=out),
                              reps=PASSES)
                 for rpb in ROWS_PER_BLOCK_CANDIDATES
                 if rows_entry_bytes(rpb, SIDE * CHANNELS, names) <= SHARED_BYTES_PER_BLOCK}
        best = min(times, key=times.get)
        plain_ms = cuda_ms(lambda: plain_rows_chunked(x, CHANNELS, names))
        note = (f"; for the record, {names} over the {NUM_IMAGES}-image rows stream "
                f"{tuple(x.shape)}: {times[best]:.4f} ms a pass at rows_per_block {best}, "
                f"plain {plain_ms:.4f} ms")
        del x, out
    print(f"[{phase} {label} vs plain] {checked} launches over {len(cases)} (rows shape, C, "
          f"chain, h_pad, storage offset) cases, C in {channels}, offsets {offsets}, "
          f"max_abs_err 0{note} [{card}]", flush=True)
    return 0


def phase_tiled_vs_plain(card: str, phase: str, label: str, fn, counter, stages: tuple,
                         seed: int, record: str | None = None) -> int:
    """Hold a tiled kernel (``fn(x, name, tile=, h_pad=, out=)``, one stage,
    launching through the wrapper ``counter``) against the plain stage on
    the tiled shapes, clamp and valid, each also with input and output at
    storage offset 1 (unaligned rows), every tile shape the autotune sweeps
    and EXTRA_TILES. With ``record``, a stage name, also time it over the
    5000-image planar stream at every tile shape, for the record. Returns
    (max-abs error, the record's best ms or None)."""
    from hipe_tpu_torch.ops.blur import FILTER_RADIUS
    from hipe_tpu_torch.ops.planar import TILE_COLS_CANDIDATES, TILE_ROWS_CANDIDATES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles = [(th, tw) for th in TILE_ROWS_CANDIDATES for tw in TILE_COLS_CANDIDATES]
    before = counter.launches
    cases = [(shape, name, h_pad, offset) for shape in TILED_SHAPES for name in stages
             for h_pad in (True, False) for offset in (0, 1)
             if h_pad or shape[1] > 2 * FILTER_RADIUS[name]]
    checked = 0
    for shape, name, h_pad, offset in cases:
        numel = shape[0] * shape[1] * shape[2]
        x = torch.randint(0, 256, (numel + offset,), dtype=torch.uint8, device=dev,
                          generator=gen)[offset:].view(shape)
        want = plain_chunked(x, (name,), h_pad)
        out = torch.empty(want.numel() + offset, dtype=torch.uint8,
                          device=dev)[offset:].view(want.shape)
        for tile in tiles + [(th, tw or shape[2]) for th, tw in EXTRA_TILES]:
            check_against(label, lambda: fn(x, name, tile=tile, h_pad=h_pad, out=out), want,
                          f"planes {shape} offset {offset} {name} h_pad={h_pad} tile={tile}")
            checked += 1
        del x, want, out
    grew = counter.launches - before
    if grew != checked:
        raise AssertionError(f"{label} launch counter grew by {grew}, expected {checked}")
    note, best_ms = "", None
    if record is not None:
        x = torch.randint(0, 256, (NUM_IMAGES * CHANNELS, SIDE, SIDE), dtype=torch.uint8,
                          device=dev, generator=gen)
        out = torch.empty_like(x)
        times = {t: cuda_ms(lambda: fn(x, record, tile=t, out=out), reps=PASSES)
                 for t in tiles}
        best = min(times, key=times.get)
        best_ms = times[best]
        note = (f"; for the record, {record} over the {NUM_IMAGES}-image planar stream "
                f"{tuple(x.shape)}: {times[best]:.4f} ms a pass at tile {best} (slowest "
                f"{max(times.values()):.4f})")
        del x, out
    print(f"[{phase} {label} vs plain] {checked} launches over {len(cases)} (shape, stage, "
          f"h_pad, storage offset) cases, {len(tiles) + len(EXTRA_TILES)} tile shapes each, "
          f"max_abs_err 0{note} [{card}]",
          flush=True)
    return 0, best_ms


def phase_rows_main_path(card: str) -> dict:
    """blur3 over the resident 5000-image rows stream through Pipeline.apply_rows."""
    from hipe_tpu_torch.models.pipelines import get
    from hipe_tpu_torch.ops.reference import gaussian_blur_int_oracle
    from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES
    from hipe_tpu_torch.utils.images import checker_image

    wrappers = reset_counts()
    pipe = get("blur3")
    image = checker_image(SIDE, SIDE, CHANNELS, seed=0)
    lane = SIDE * CHANNELS
    one = torch.from_numpy(image.reshape(1, SIDE, lane)).cuda()
    rows = one.expand(NUM_IMAGES, SIDE, lane).contiguous()
    bufs = (torch.empty_like(rows), torch.empty_like(rows))

    def passes(rpb: int, r: int) -> torch.Tensor:
        x = rows
        for i in range(r):
            x = pipe.apply_rows(x, CHANNELS, rows_per_block=rpb, out=bufs[i % 2])
        return x

    fits = sorted({*ROWS_PER_BLOCK_CANDIDATES, SIDE})  # K1 takes no shared memory
    tune = {rpb: cuda_ms(lambda: passes(rpb, PASSES)) / PASSES for rpb in fits}
    best = min(tune, key=tune.get)
    ms, sessions = median_pass_ms(lambda: passes(best, PASSES))
    first = passes(best, 1)[0].cpu().numpy().reshape(SIDE, SIDE, CHANNELS)
    err = int(abs(first.astype(int) - gaussian_blur_int_oracle(image).astype(int)).max())
    got = passes(best, 3)
    counts = check_counts(wrappers, {"K1 rows": SESSIONS * 3 * PASSES}, "rows blur3")
    want = rows
    for _ in range(3):
        want = plain_rows_chunked(want, CHANNELS, pipe.filters)
    chain_err = max_abs_err(got, want)
    if err or chain_err:
        raise AssertionError(f"rows blur3 main path: max_abs_err {err}, after 3 chained "
                             f"passes {chain_err}")
    del want, got
    plain_ms = cuda_ms(lambda: plain_rows_chunked(rows, CHANNELS, pipe.filters))
    copy_ms = cuda_ms(lambda: bufs[0].copy_(rows), reps=PASSES)
    print(f"[13 rows main path] blur3 apply_rows {NUM_IMAGES}x{SIDE}x{lane} rows: sweep "
          f"{ {k: round(v, 4) for k, v in tune.items()} } ms/pass, chose rows_per_block "
          f"{best}; max_abs_err {err} (oracle), {chain_err} (3 chained passes vs plain); "
          f"sessions {[round(t, 4) for t in sessions]} ms/pass, median {ms:.4f} ms, "
          f"{NUM_IMAGES / ms * 1e3:.1f} img/s, {2 * rows.numel() / ms / 1e6:.1f} GB/s; plain "
          f"per-pass {plain_ms:.4f} ms; Tensor.copy_ of the rows {copy_ms:.4f} ms; K1 rows "
          f"launches {counts['K1 rows']} [{card}]", flush=True)
    del rows, bufs
    torch.cuda.empty_cache()
    return {"launches": counts["K1 rows"], "ms": ms, "plain_ms": plain_ms,
            "chain_err": chain_err, "copy_ms": copy_ms}


def phase_large_frames(card: str, pipeline: str) -> dict:
    """Drive 100 frames of 4000x2250 through DeviceStreamRunner: the chain
    on K4/K5 (too wide for K2), blur3 on K1 (no width limit), each beside
    the other route's time."""
    from hipe_tpu_torch.ops import cuda_tiled
    from hipe_tpu_torch.ops.blur import FILTER_RADIUS, GAUSSIANS
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda
    from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
    from hipe_tpu_torch.ops.planar import (SHARED_BYTES_PER_BLOCK, TILE_COLS_CANDIDATES,
                                           TILE_ROWS_CANDIDATES, fused_shared_bytes,
                                           tiled_shared_bytes)
    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu_torch.utils.images import checker_image

    wrappers = reset_counts()
    image = checker_image(LARGE_H, LARGE_W, CHANNELS, seed=0)
    runner = DeviceStreamRunner(pipeline, num_images=LARGE_FRAMES, image=image, device="cuda")
    names = runner.pipeline.filters
    tiled = runner.pipeline.routes_tiled(LARGE_H, LARGE_W)
    if tiled == runner.pipeline.single_gaussian:
        raise AssertionError(f"{pipeline} at {LARGE_W}x{LARGE_H} routes "
                             f"{'tiled' if tiled else 'fused'}: K1 takes a single "
                             "gaussian at any width, K4/K5 every other chain this wide")
    timings = runner.autotune()
    err = runner.verify_max_abs_err()
    sessions = [runner.measure_throughput(passes=PASSES, reps=3) for _ in range(SESSIONS)]
    busy = device_busy(lambda: runner.run_passes(PASSES))
    got = runner.run_passes(3)
    timed = SESSIONS * 3 * PASSES
    n_k4 = sum(nm in GAUSSIANS for nm in names)
    if tiled:
        expect = {"K4": timed * n_k4}
        if len(names) > n_k4:
            expect["K5"] = timed * (len(names) - n_k4)
    else:
        expect = {"K1": timed}
    counts = check_counts(wrappers, expect, f"{pipeline} large-frame")
    want = runner.stream
    for _ in range(3):
        want = plain_chunked(want, names)
    chain_err = max_abs_err(got, want)
    if err or chain_err:
        raise AssertionError(f"{pipeline} large frames: max_abs_err {err}, after 3 "
                             f"chained passes {chain_err}")
    del want, got
    stream, buf = runner.stream, runner._bufs[0]
    plain_ms = cuda_ms(lambda: plain_chunked(stream, names))
    k4_names = tuple(nm for nm in names if nm in GAUSSIANS)
    k5_names = tuple(nm for nm in names if nm not in GAUSSIANS)
    tiles = [t for t in ((th, tw) for th in TILE_ROWS_CANDIDATES for tw in TILE_COLS_CANDIDATES)
             if max(tiled_shared_bytes(nm, t) for nm in names) <= SHARED_BYTES_PER_BLOCK]
    own = {}
    if tiled:
        # Each kernel's own time a pass at the chosen tile (its stages on the
        # stream), and the plain version of those stages.
        tile = runner.config["tile"]
        for label, stages, fn in (
                ("K4", k4_names, lambda nm, t=tile: cuda_tiled.gaussian_blur_planar_tiled_cuda(
                    stream, FILTER_RADIUS[nm], tile=t, out=buf)),
                ("K5", k5_names, lambda nm, t=tile: cuda_tiled.filter_stage_planar_tiled_cuda(
                    stream, nm, tile=t, out=buf))):
            if stages:
                ms = cuda_ms(lambda: [fn(nm) for nm in stages], reps=PASSES)
                plain = cuda_ms(lambda: [plain_chunked(stream, (nm,)) for nm in stages])
                # For the record: the kernel at the swept tile that suits it
                # best (the runner picks one tile for the whole chain).
                best = min((cuda_ms(lambda: [fn(nm, t) for nm in stages], reps=3), t)
                           for t in tiles)
                own[label] = {"ms": ms, "plain_ms": plain, "best": best,
                              "bound": bound(2 * stream.numel() * len(stages), stages,
                                             stream.numel())}
        # The fused route at the tallest tile that fits, for the record.
        rpb = max(r for r in range(1, LARGE_H + 1)
                  if fused_shared_bytes(r, LARGE_W, names) <= SHARED_BYTES_PER_BLOCK)
        other = ("fused route K2", rpb, cuda_ms(lambda: filter_chain_planar_cuda(
            stream, names, rows_per_block=rpb, out=buf), reps=PASSES))
    else:
        # K1's own time a pass at the chosen band height; beside it, K4 (the
        # tiled route this stream took before K1 lost its width limit) at
        # every swept tile, the fastest kept, in the same run.
        rpb = runner.config["rows_per_block"]
        radius = FILTER_RADIUS[names[0]]
        ms = cuda_ms(lambda: gaussian_blur_planar_cuda(stream, radius, rows_per_block=rpb,
                                                       out=buf), reps=PASSES)
        own["K1"] = {"ms": ms, "plain_ms": plain_ms, "best": (ms, rpb),
                     "bound": bound(2 * stream.numel(), names, stream.numel())}
        k4 = {t: cuda_ms(lambda: cuda_tiled.gaussian_blur_planar_tiled_cuda(
            stream, radius, tile=t, out=buf), reps=PASSES) for t in tiles}
        best = min(k4, key=k4.get)
        other = (f"tiled route K4 (all tiles {dict((f'{t[0]}x{t[1]}', round(v, 4)) for t, v in k4.items())})",
                 best, k4[best])
    # Yardsticks the port never calls: a copy of the stream (the rate a
    # kernel that reads and writes it once can reach), and the one-call
    # counterparts of K5's invert and posterize4, beside K5's own times.
    yard = {"copy_": cuda_ms(lambda: buf.copy_(stream), reps=PASSES)}
    if tiled:
        tile = runner.config["tile"]
        yard["bitwise_not"] = cuda_ms(lambda: torch.bitwise_not(stream, out=buf), reps=PASSES)
        yard["bitwise_and"] = cuda_ms(lambda: torch.bitwise_and(stream, 0xF0, out=buf),
                                      reps=PASSES)
        for nm in ("invert", "posterize4"):
            yard[f"K5 {nm}"] = cuda_ms(lambda: cuda_tiled.filter_stage_planar_tiled_cuda(
                stream, nm, tile=tile, out=buf), reps=PASSES)
    by_rate = sorted(sessions, key=lambda x: x["img_per_s"])
    med = by_rate[len(by_rate) // 2]
    print(f"[14 large frames] {pipeline} {names} {LARGE_FRAMES}x{LARGE_W}x{LARGE_H}x"
          f"{CHANNELS} ({stream.numel() / 1e9:.2f} GB): autotune "
          f"{ {k: round(v * 1e3, 4) for k, v in timings.items()} } ms/pass, chose "
          f"{runner.tuning['chosen']}; max_abs_err {err}; sessions frames/s "
          f"{[round(x['img_per_s'], 2) for x in by_rate]}; median per-pass "
          f"{med['per_pass_s'] * 1e3:.4f} ms, {med['img_per_s']:.2f} frames/s, "
          f"{med['gb_per_s']:.1f} GB/s; device idle over {PASSES} passes "
          f"{1 - busy[1] / busy[0]:.2%} (kernels {busy[1]:.3f} of {busy[0]:.3f} ms); "
          f"plain per-pass {plain_ms:.4f} ms; own "
          f"{ {k: {'ms': round(v['ms'], 4), 'plain_ms': round(v['plain_ms'], 4), 'best': v['best'][1], 'best_ms': round(v['best'][0], 4)} for k, v in own.items()} }; "
          f"{other[0]} at {other[1]}: {other[2]:.4f} ms/pass; yardsticks "
          f"{ {k: round(v, 4) for k, v in yard.items()} } ms (copy_ "
          f"{2 * stream.numel() / yard['copy_'] / 1e6:.1f} GB/s); launches "
          f"{ {k: n for k, n in counts.items() if n} } [{card}]", flush=True)
    del runner, stream, buf
    torch.cuda.empty_cache()
    return {"counts": counts, "ms": med["per_pass_s"] * 1e3, "plain_ms": plain_ms,
            "chain_err": chain_err, "own": own, "other_ms": other[2], "other_at": other[1],
            "yard": yard}


def phase_dct_build(card: str) -> dict:
    """The ptxas report of K6, K7 and K11 (built in phase 2 with the rest);
    fails if K7 spills or keeps a stack frame."""
    import re

    from hipe_tpu_torch.ops import _build

    log = (_build.build().parent / "build.log").read_text()
    found = {}
    for entry in log.split("Compiling entry function")[1:]:
        head = entry.split("\n")[0]
        dct = re.search(r"(dequant_idct|fdct_quantize)_kernel", head)
        # K11's instantiations: ycc_rows_<form>_kernel<fancy>, mangled.
        k11 = re.search(r"ycc_rows_(vec|any)_kernelILb([01])E", head)
        name = (dct.group(0) if dct else k11 and
                f"ycc_rows_{k11.group(1)}_kernel<{bool(int(k11.group(2)))}>")
        if name:
            barriers = re.search(r"used (\d+) barriers", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            found[name] = (*ptxas_numbers(entry),
                                    int(barriers.group(1)) if barriers else -1,
                                    int(smem.group(1)) if smem else -1)
    k11 = {f"ycc_rows_{form}_kernel<{fancy}>" for form in ("vec", "any")
           for fancy in (True, False)}
    if set(found) != {"dequant_idct_kernel", "fdct_quantize_kernel"} | k11:
        raise AssertionError(f"build.log has no ptxas report of K6, K7 and K11: {found}")
    if found["fdct_quantize_kernel"][1:4] != (0, 0, 0):
        raise AssertionError(f"K7 spills or keeps a stack frame: {found}")
    print("[15 codec build] csrc/dct_blocks.cu, csrc/ycc_rows.cu (registers, spill stores, "
          "spill loads, stack frame, barriers, shared bytes): " + "; ".join(
              f"{name} {'/'.join(str(n) for n in nums)}" for name, nums in sorted(found.items()))
          + f" [{card}]", flush=True)
    return found


def chunked(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn`` over batch chunks of x (the plain versions' int32 temporaries)."""
    k = _chunk(x)
    return torch.cat([fn(x[i:i + k], *args) for i in range(0, x.shape[0], k)])


def random_tables(gen: torch.Generator) -> dict:
    """A random 8-bit and a random 16-bit quant table (65535 among its entries)."""
    q8 = torch.randint(1, 256, (64,), generator=gen, device=gen.device).cpu()
    q16 = torch.randint(1, 65536, (64,), generator=gen, device=gen.device).cpu()
    q16[0] = 65535
    return {"random 8-bit": q8, "random 16-bit": q16}


def phase_dct_vs_plain(card: str, phase: str, label: str, fn, plain, make_input, tables: dict,
                       main_shapes: tuple, main_table, seed: int) -> int:
    """Hold a DCT kernel (``fn(x, q)``, its launch count growing by one a
    launch) against its plain version on DCT_GRIDS in batches of 1-8, for
    every input kind ``make_input(shape, kind, gen)`` returns and every
    table, and on the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = {**tables, **random_tables(gen)}
    cases = []
    for gi, (hb, wb) in enumerate(DCT_GRIDS):
        for ti, (tname, q) in enumerate(tables.items()):
            for kind in make_input.kinds:
                cases.append(((1 + (gi + ti) % 8, hb, wb), kind, tname, q))
    cases += [((NUM_IMAGES, hb, wb), make_input.kinds[-1], "main path", main_table)
              for hb, wb in main_shapes]
    before = fn.launches
    for shape, kind, tname, q in cases:
        x = make_input(shape, kind, gen)
        check_against(label, lambda: fn(x, q), chunked(plain, x, q),
                      f"{shape} blocks, {kind}, {tname} table")
        del x
    grew = fn.launches - before
    if grew != len(cases):
        raise AssertionError(f"{label} launch counter grew by {grew}, expected {len(cases)}")
    print(f"[{phase} {label} vs plain] {len(cases)} launches over block grids {DCT_GRIDS} "
          f"(batches 1-8) and the main path's {main_shapes} x {NUM_IMAGES}, inputs "
          f"{make_input.kinds}, tables {list(tables)}: max_abs_err 0 [{card}]", flush=True)
    return 0


def random_coefs(shape: tuple, kind: str, gen: torch.Generator) -> torch.Tensor:
    """(B, Hb, Wb, 64) int16: the full int16 range with +-32767 and -32768
    among them, or [-2048, 2048)."""
    b, hb, wb = shape
    lo, hi = (-32768, 32768) if kind == "full int16" else (-2048, 2048)
    x = torch.randint(lo, hi, (b, hb, wb, 64), dtype=torch.int32, device=gen.device,
                      generator=gen).to(torch.int16)
    if kind == "full int16":
        x.view(-1)[:4] = torch.tensor([32767, -32767, -32768, 32767], dtype=torch.int16)
    return x


random_coefs.kinds = ("full int16", "[-2048, 2048)")


def extreme_blocks() -> torch.Tensor:
    """(130, 8, 8) uint8: for each coefficient (u, v), the block of 0s and
    255s by the signs of the DCT basis cos((2x+1)u pi/16) cos((2y+1)v pi/16),
    which takes it to its largest value, and the complement, its least; then
    a block of 0s and one of 255s (the DC's: |t| 8192 and 8128)."""
    import math

    x = torch.arange(8, dtype=torch.float64)
    basis = torch.stack([torch.cos((2 * x + 1) * u * math.pi / 16) for u in range(8)]) > 0
    top = torch.stack([basis[u][:, None] == basis[v][None, :] for u in range(8)
                       for v in range(8)]).to(torch.uint8) * 255
    return torch.cat([top, 255 - top, torch.zeros((1, 8, 8), dtype=torch.uint8),
                      torch.full((1, 8, 8), 255, dtype=torch.uint8)])


def random_grid(shape: tuple, kind: str, gen: torch.Generator) -> torch.Tensor:
    """(B, Hb*8, Wb*8) uint8: flat blocks of 0 or 255, the extreme blocks in
    turn from a random start, or random samples."""
    b, hb, wb = shape
    dev = gen.device
    if kind == "uint8":
        return torch.randint(0, 256, (b, hb * 8, wb * 8), dtype=torch.uint8, device=dev,
                             generator=gen)
    if kind == "flat 0/255":
        flat = torch.randint(0, 2, (b * hb * wb,), device=dev, generator=gen) * 255
        blocks = flat.to(torch.uint8)[:, None, None].expand(-1, 8, 8)
    else:
        ext = extreme_blocks().to(dev)
        start = torch.randint(0, len(ext), (1,), device=dev, generator=gen)
        blocks = ext[(torch.arange(b * hb * wb, device=dev) + start) % len(ext)]
    blocks = blocks.reshape(b, hb, wb, 8, 8).transpose(2, 3)
    return blocks.reshape(b, hb * 8, wb * 8).contiguous()


random_grid.kinds = ("flat 0/255", "sign patterns", "uint8")


def phase_k6_vs_plain(card: str) -> int:
    from hipe_tpu_torch.io_.jpeg import quality_tables
    from hipe_tpu_torch.ops.cuda_dct import dequant_idct_cuda
    from hipe_tpu_torch.ops.jpeg_decode import idct8x8_islow

    return phase_dct_vs_plain(card, "16", "K6", dequant_idct_cuda, idct8x8_islow, random_coefs,
                              {}, ((32, 32), (16, 16)), quality_tables(90)[0], seed=7)


def phase_k7_vs_plain(card: str) -> int:
    from hipe_tpu_torch.io_.jpeg import quality_tables
    from hipe_tpu_torch.ops.cuda_dct import fdct_quantize_cuda
    from hipe_tpu_torch.ops.jpeg_encode import fdct_quantize_plain

    tables = {f"{part} q{q}": t for q in QUALITIES
              for part, t in zip(("luma", "chroma"), quality_tables(q))}
    tables.update({"all 1": torch.ones(64, dtype=torch.int64),
                   "all 65535": torch.full((64,), 65535, dtype=torch.int64)})
    return phase_dct_vs_plain(card, "17", "K7", fdct_quantize_cuda, fdct_quantize_plain,
                              random_grid, tables, ((32, 32), (16, 16)),
                              quality_tables(90)[1], seed=8)


def phase_codec_main_paths(card: str) -> dict:
    """The codec's four main paths over the resident 5000-image 4:2:0 stream."""
    from hipe_tpu_torch.io_.jpeg import quality_tables
    from hipe_tpu_torch.ops import cuda_dct
    from hipe_tpu_torch.ops import jpeg_decode as jd
    from hipe_tpu_torch.ops import jpeg_encode as je
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_rows_cuda
    from hipe_tpu_torch.runtime.serve import ServingPipeline
    from hipe_tpu_torch.utils.images import checker_image

    dev = torch.device("cuda")
    image = checker_image(SIDE, SIDE, CHANNELS, seed=0)
    geo = je.encode_geometry(SIDE, SIDE, CHANNELS, "420")
    luma, chroma = quality_tables(90)
    qt = [luma, chroma, chroma]
    qkey = tuple(tuple(int(v) for v in q) for q in qt)
    one = torch.from_numpy(image).to(dev)[None]
    # The stream: the image's coefficients in 5000 distinct per-image buffers.
    coefs = tuple(c.expand(NUM_IMAGES, *c.shape[1:]).contiguous()
                  for c in je.encode_planes(geo, one, qt))
    rows = one.reshape(1, SIDE, SIDE * CHANNELS).expand(NUM_IMAGES, -1, -1).contiguous()
    serve = ServingPipeline("blur3", device=dev, decode_on_device=True, encode_on_device=True)
    encode = serve.encode_fn(SIDE, SIDE, CHANNELS, with_filter=False)
    decode_filter = serve.decode_filter_fn(geo, qkey)
    transcode = serve.transcode_fn(geo, qkey)

    def decode(*c):
        return jd.decode_planes(geo, list(c), qt, layout="rows")

    def chained(n: int):
        x = coefs
        for _ in range(n):
            x = transcode(*x)
        return x

    # The plain path on the card: the same torch work between the kernels,
    # the plain DCTs, the plain upsample + colour and the plain rows blur.
    def plain_decode(*c):
        with plain_kernels():
            return jd._rows_from_grids(
                geo, [chunked(jd.idct8x8_islow, x, q) for x, q in zip(c, qt)])

    def plain_encode(r):
        grids = je._sample_grids(geo, r.reshape(r.shape[0], SIDE, SIDE, CHANNELS))
        return [chunked(je.fdct_quantize_plain, g, q) for g, q in zip(grids, qt)]

    def plain_transcode(*c):
        return plain_encode(plain_rows_chunked(plain_decode(*c), CHANNELS, ("gaussian3",)))

    def same(got, want, what: str) -> int:
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        err = max(max_abs_err(g.reshape(want_.shape), want_) for g, want_ in zip(got, want))
        if err:
            raise AssertionError(f"codec {what} differs from the plain path: max-abs {err}")
        return err

    paths = {
        "encode": (lambda: encode(rows), {"K7": 3},
                   lambda: plain_encode(rows)),
        "decode": (lambda: decode(*coefs), {"K6": 3, "K11": 1}, lambda: plain_decode(*coefs)),
        "decode + blur3": (lambda: decode_filter(*coefs), {"K6": 3, "K11": 1, "K1 rows": 1},
                           lambda: plain_rows_chunked(plain_decode(*coefs), CHANNELS,
                                                      ("gaussian3",))),
        "transcode": (None, {"K6": 3, "K11": 1, "K1 rows": 1, "K7": 3}, None),
    }
    results = {}
    for name, (one_pass, per_pass, plain) in paths.items():
        # The passes between reset_counts and check_counts: SESSIONS sessions
        # of a warm-up and 3 timed calls, the profiled window's warm-up and
        # call (each call PASSES passes), then the kept result (3 chained
        # transcode passes, or 1).
        runs = SESSIONS * 4 * PASSES + 2 * PASSES + (3 if name == "transcode" else 1)
        wrappers = reset_counts()
        if name == "transcode":
            ms, sessions = median_pass_ms(lambda: chained(PASSES))
            busy = device_busy(lambda: chained(PASSES))
            got = chained(3)
            counts = check_counts(wrappers, {k: v * runs for k, v in per_pass.items()}, name,
                                  exact=True)
            want = coefs
            for _ in range(3):
                want = plain_transcode(*want)
            plain_ms = cuda_ms(lambda: plain_transcode(*coefs))
            err = same(got, want, "transcode after 3 chained passes")
        else:
            ms, sessions = median_pass_ms(lambda: [one_pass() for _ in range(PASSES)])
            busy = device_busy(lambda: [one_pass() for _ in range(PASSES)])
            got = one_pass()
            counts = check_counts(wrappers, {k: v * runs for k, v in per_pass.items()}, name,
                                  exact=True)
            err = same(got, plain(), name)
            plain_ms = cuda_ms(plain)
        results[name] = {"ms": ms, "sessions": sessions, "plain_ms": plain_ms, "err": err,
                         "idle": 1 - busy[1] / busy[0], "counts": counts, "passes": runs,
                         # Launches a pass, from the counts over the passes.
                         "per_pass": {k: n // runs for k, n in counts.items() if n}}
        del got
        print(f"[18 codec main path] {name}, {NUM_IMAGES} images of {SIDE}x{SIDE}x{CHANNELS} "
              f"4:2:0 q90: sessions {[round(t, 4) for t in sessions]} ms/pass, median "
              f"{ms:.4f} ms, {NUM_IMAGES / ms * 1e3:.1f} img/s; max_abs_err {err} against "
              f"the plain path ({'after 3 chained passes, ' if name == 'transcode' else ''}"
              f"plain {plain_ms:.4f} ms/pass); device idle over {PASSES} passes "
              f"{results[name]['idle']:.2%} (kernels {busy[1]:.3f} of {busy[0]:.3f} ms); "
              f"launches { {k: n for k, n in counts.items() if n} } over {runs} passes "
              f"[{card}]", flush=True)
    # The first image, decoded on the card, against the port's CPU path.
    cpu_first = jd.decode_planes(geo, [c[:1].cpu() for c in coefs], qt, layout="rows")
    first_err = max_abs_err(decode(*(c[:1] for c in coefs)).cpu(), cpu_first)
    cpu_coefs = je.encode_planes(geo, one.cpu(), qt)
    stream_err = max(max_abs_err(c[:1].cpu(), w) for c, w in zip(coefs, cpu_coefs))
    if first_err or stream_err:
        raise AssertionError(f"card against CPU: decode {first_err}, encode {stream_err}")
    # Where a transcode pass goes: each kernel's own launches and the torch
    # work between them, on this stream.
    grids = [cuda_dct.dequant_idct_cuda(c, q) for c, q in zip(coefs, qt)]
    dec_rows = jd._rows_from_grids(geo, grids)
    blurred = gaussian_blur_rows_cuda(dec_rows, CHANNELS, 1)
    enc_grids = je._sample_grids(geo, blurred.reshape(NUM_IMAGES, SIDE, SIDE, CHANNELS))
    outs = [torch.empty_like(c) for c in coefs]
    split = {
        "K6": cuda_ms(lambda: [cuda_dct.dequant_idct_cuda(c, q, out=g)
                               for c, q, g in zip(coefs, qt, grids)], reps=PASSES),
        "K11": cuda_ms(lambda: jd._rows_from_grids(geo, grids, out=dec_rows), reps=PASSES),
        "K1 rows": cuda_ms(lambda: gaussian_blur_rows_cuda(dec_rows, CHANNELS, 1, out=blurred),
                           reps=PASSES),
        "encode torch work": cuda_ms(lambda: je._sample_grids(
            geo, blurred.reshape(NUM_IMAGES, SIDE, SIDE, CHANNELS)), reps=PASSES),
        "K7": cuda_ms(lambda: [cuda_dct.fdct_quantize_cuda(g, q, out=o)
                               for g, q, o in zip(enc_grids, qt, outs)], reps=PASSES),
    }
    plain_k6 = cuda_ms(lambda: [chunked(jd.idct8x8_islow, c, q) for c, q in zip(coefs, qt)])
    with plain_kernels():
        plain_k11 = cuda_ms(lambda: jd._rows_from_grids(geo, grids))
    plain_k7 = cuda_ms(lambda: [chunked(je.fdct_quantize_plain, g, q)
                                for g, q in zip(enc_grids, qt)])
    samples = sum(g.numel() for g in grids)
    coef_bytes = sum(c.numel() * 2 for c in coefs)
    bounds = {}
    for label, ops in (("K6", K6_OPS_PER_SAMPLE), ("K7", K7_OPS_PER_SAMPLE)):
        t_bytes = (coef_bytes + samples) / HBM_BYTES_PER_S * 1e3
        t_ops = ops * samples / INT32_OPS_PER_S * 1e3
        bounds[label] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"[18 codec main path] the transcode pass split: "
          f"{ {k: round(v, 4) for k, v in split.items()} } ms (sum "
          f"{sum(split.values()):.4f}, pass {results['transcode']['ms']:.4f}); plain K6 "
          f"{plain_k6:.4f} ms, plain K11 {plain_k11:.4f} ms, plain K7 {plain_k7:.4f} ms; "
          f"bounds K6 {bounds['K6'][0]:.4f} ms "
          f"({bounds['K6'][1]}), K7 {bounds['K7'][0]:.4f} ms ({bounds['K7'][1]}) over "
          f"{samples} samples and {coef_bytes} coefficient bytes; first image and stream "
          f"against the CPU path: max_abs_err 0 [{card}]", flush=True)
    serve.close()
    del coefs, rows, grids, dec_rows, blurred, enc_grids, outs
    torch.cuda.empty_cache()
    k11 = k11_bench_grids(card)
    return {"paths": results, "split": split, "plain_k6": plain_k6, "plain_k7": plain_k7,
            "plain_k11": plain_k11, "bounds": bounds, "k11": k11}


# The codec cell's images: 320x240 4:2:0.
BENCH_H, BENCH_W = 240, 320
# K11 over them: (label, scale_denom, bytes each grid's base lies past an
# aligned start, the form the kernel must take). Full size is the cell's
# decode; bases one byte off and the 1/8 decode (40x30: no whole run of 16
# pixels a row) take the any form.
K11_CASES = (("the cell", 1, 0, "vec"), ("the cell, bases 1 byte off", 1, 1, "any"),
             ("the cell at 1/8", 8, 0, "any"))


def k11_form(fn) -> str:
    """The form of K11 (``vec`` or ``any``) that ``fn`` launches, from the
    kernel names torch.profiler records over a warm-up and PASSES calls (one
    call of ~1 ms is too short a window for it to record reliably); raises
    unless it is one."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PASSES):
            fn()
        torch.cuda.synchronize()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA}
    forms = {m.group(1) for name in names
             for m in [re.search(r"ycc_rows_(vec|any)_kernel", name)] if m}
    if len(forms) != 1:
        raise AssertionError(f"K11's calls launched the forms {forms or 'none'}; the "
                             f"device events: {sorted(names)[:8]}")
    return forms.pop()


def k11_bench_grids(card: str) -> dict:
    """Phase 18: K11 alone over grids of the codec cell's shapes (5000
    images of 320x240 4:2:0, random samples) in each of K11_CASES: the form
    it takes, ms a launch beside its bound (the bytes it must move over
    3.35 TB/s), a ``Tensor.copy_`` moving as many bytes (a yardstick the
    port never calls) and its plain version on the card, and its output
    against it."""
    from hipe_tpu_torch.ops import cuda_dct
    from hipe_tpu_torch.ops import jpeg_decode as jd
    from hipe_tpu_torch.ops import jpeg_encode as je

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    geo = je.encode_geometry(BENCH_H, BENCH_W, CHANNELS, "420")
    results = {}
    for label, denom, offset, want_form in K11_CASES:
        sizes = jd.scaled_sizes(geo, denom)
        shapes = [(NUM_IMAGES, hb * ss, wb * ss) for (_, _, wb, hb), ss in zip(geo.comps, sizes)]
        grids = []
        for sh in shapes:
            n = sh[0] * sh[1] * sh[2]
            buf = torch.empty(n + offset, dtype=torch.uint8, device=dev)
            buf[offset:] = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                                         generator=gen)
            grids.append(buf[offset:].view(sh))
        fancy = jd.ycc_rows_fancy(geo, denom)
        args = (fancy, jd._scaled_down_dims(geo, 1, sizes[1]),
                (-(-BENCH_H // denom), -(-BENCH_W // denom)))
        oh, ow = args[2]
        out = torch.empty((NUM_IMAGES, oh, ow * 3), dtype=torch.uint8, device=dev)
        wrappers = reset_counts()
        form = k11_form(lambda: cuda_dct.ycc_rows_cuda(*grids, *args, out=out))
        if form != want_form:
            raise AssertionError(f"K11 took the {form} form over {label}, not {want_form}")
        ms = cuda_ms(lambda: cuda_dct.ycc_rows_cuda(*grids, *args, out=out), reps=PASSES)
        if wrappers["K11"].launches != 2 * PASSES + 2:
            raise AssertionError(f"K11 launched {wrappers['K11'].launches} times over "
                                 f"{label}, not {2 * PASSES + 2}")
        plain = jd.ycc_rows_plain(*grids, *args)
        err = max_abs_err(out, plain)
        if err:
            raise AssertionError(f"K11 differs from its plain version over {label}: "
                                 f"max-abs {err}")
        del plain
        plain_ms = cuda_ms(lambda: jd.ycc_rows_plain(*grids, *args))
        moved = sum(g.numel() for g in grids) + out.numel()
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = cuda_ms(lambda: dst.copy_(src), reps=PASSES)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        print(f"[18 codec main path] K11 alone over {label}: {NUM_IMAGES} images of {ow}x{oh}, "
              f"{'fancy h2v2' if fancy else 'chroma at the output resolution'} (grids "
              f"{shapes[0][1:]} and 2 x {shapes[1][1:]}, bases {offset} bytes off): the "
              f"{form} form, {ms:.4f} ms a launch, {bound_ms / ms:.1%} of its bound "
              f"{bound_ms:.4f} ms (bytes: {moved}); a copy_ of {moved // 2} bytes (as many "
              f"moved) {copy_ms:.4f} ms, K11 {ms / copy_ms:.3f}x it; plain {plain_ms:.4f} ms; "
              f"max_abs_err {err} against the plain version [{card}]", flush=True)
        results[label] = {"form": form, "ms": ms, "plain_ms": plain_ms, "copy_ms": copy_ms,
                          "bound_ms": bound_ms, "bytes": moved, "err": err}
        del grids, out, src, dst
        torch.cuda.empty_cache()
    return results


# Phase 19: the reference's programs (its stream: 5000 images of 320x240x3).
A_H, A_W, A_DISTINCT = 240, 320, 500
# Images of batch 0 held against the NumPy oracle itself; the whole of
# batch 0 is held against the plain chain on the card, which is held
# against the oracle on these.
A_ORACLE_IMAGES = 100


class SeededStream:
    """``num_images`` images of 240x320x3 in batches: the first 500 distinct
    random images (seeded numpy), the rest replicate
    ``checker_image(240, 320, 3, seed=0)`` as the reference's stream does."""

    def __init__(self, distinct, num_images: int, batch_size: int):
        from hipe_tpu_torch.runtime.stream import batch_sizes
        from hipe_tpu_torch.utils.images import checker_image

        self.distinct = distinct
        self.image = checker_image(A_H, A_W, CHANNELS, seed=0)
        self.sizes = batch_sizes(num_images, batch_size)

    def batch_shapes(self) -> list[tuple]:
        return [(bc, A_H, A_W, CHANNELS) for bc in self.sizes]

    def __iter__(self):
        start = 0
        for bc in self.sizes:
            head = self.distinct[start:start + bc]
            tail = np.broadcast_to(self.image, (bc - len(head),) + self.image.shape)
            yield head if len(tail) == 0 else tail if len(head) == 0 else np.concatenate(
                [head, tail])
            start += bc


def lane_text(name: str, c) -> str:
    return (f"{name} {c.images} img in {c.in_ms:.2f} kernel {c.kernel_ms:.2f} "
            f"out {c.out_ms:.2f} ms")


def cuda_lane_batches(cfg, sizes: list[int], accel_images: int) -> tuple[int, int]:
    """(batches, warm-up shapes) the CUDA lane of a two-lane run takes: one
    launch of the path's kernel each."""
    from hipe_tpu_torch.parallel.partitioner import split_images

    if cfg.approach == 2:
        return len(sizes), len(set(sizes))
    if cfg.scheduler == "greedy":
        if accel_images % cfg.batch_size:
            raise AssertionError("a greedy run here takes whole batches only")
        return accel_images // cfg.batch_size, len(set(sizes))
    acc = [bc if cfg.mode == "gpu" else split_images(bc, cfg.gpu_ratio)[1] for bc in sizes]
    return sum(1 for n in acc if n), len({n for n in acc if n})


def phase_engine(card: str) -> dict:
    """Phase 19: approach 1 and 2 and the fleet over a host-CPU lane and the
    card; each run's launches, taken over that run alone, and its batch 0
    against the plain chain (blur3: and the NumPy oracle)."""
    from hipe_tpu_torch.models import pipelines as plib
    from hipe_tpu_torch.ops.reference import gaussian_blur_int_oracle
    from hipe_tpu_torch.parallel.autotune import calibrate_ratio
    from hipe_tpu_torch.parallel.partitioner import imbalance_pct
    from hipe_tpu_torch.runtime.engine import Engine, EngineConfig
    from hipe_tpu_torch.runtime.fleet import FleetEngine, LaneSpec
    from hipe_tpu_torch.runtime.stream import batch_sizes
    from hipe_tpu_torch.utils.images import checker_image

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    distinct = np.random.default_rng(19).integers(0, 256, (A_DISTINCT, A_H, A_W, CHANNELS),
                                                  dtype=np.uint8)
    # The plain chains on the card over the 500 distinct images, and the
    # NumPy oracle over the first A_ORACLE_IMAGES (as (H, W, B*C) planes).
    x = torch.from_numpy(distinct).to(dev)
    want = {name: plib.get(name)(x).cpu().numpy() for name in ("blur3", "chain")}
    del x
    head = distinct[:A_ORACLE_IMAGES].transpose(1, 2, 0, 3).reshape(A_H, A_W, -1)
    oracle = gaussian_blur_int_oracle(head, 1).reshape(A_H, A_W, A_ORACLE_IMAGES, CHANNELS)
    oracle_err = max_abs_err(torch.from_numpy(oracle.transpose(2, 0, 1, 3)),
                             torch.from_numpy(want["blur3"][:A_ORACLE_IMAGES]))
    if oracle_err:
        raise AssertionError(f"the plain blur3 on the card != the NumPy oracle: {oracle_err}")
    print(f"[19 engine] {NUM_IMAGES} images of {A_W}x{A_H}x{CHANNELS}, the first "
          f"{A_DISTINCT} distinct (seeded), the rest replicated; batch 0 held against the "
          f"plain chain on the card, which equals the NumPy oracle on {A_ORACLE_IMAGES} "
          f"images; torch {torch.get_num_threads()} intra-op threads on {os.cpu_count()} "
          f"cores [{card}]", flush=True)

    calibrated = {}
    results = {}

    def calibrate(approach: int) -> float:
        base = EngineConfig(approach=approach, mode="both", batch_size=100, num_images=300)
        res = calibrate_ratio(base, checker_image(A_H, A_W, CHANNELS, seed=0))
        calibrated[approach] = res
        print(f"[19 calibrate A{approach}] history (ratio, imbalance %) "
              f"{[(round(r, 4), round(i, 2)) for r, i in res.history]} -> {res.ratio:.4f} "
              f"[{card}]", flush=True)
        return res.ratio

    def run(label: str, num_images: int = NUM_IMAGES, **kw) -> dict:
        cfg = EngineConfig(num_images=num_images, **kw)
        wrappers = reset_counts()
        eng = Engine(cfg)
        stats = eng.run(stream=SeededStream(distinct, num_images, eng.config.batch_size))
        counts = {k: fn.launches for k, fn in wrappers.items()}
        cfg = eng.config
        kernel = "K1 rows" if eng.pipeline.single_gaussian else "K2"
        sizes = batch_sizes(num_images, cfg.batch_size)
        batches, warmups = cuda_lane_batches(cfg, sizes, stats.accel.images)
        if counts[kernel] != batches + warmups or any(
                n for k, n in counts.items() if k != kernel):
            raise AssertionError(f"{label}: launches {counts}, expected {kernel} "
                                 f"{batches} + {warmups} warm-up and no other")
        got = eng.first_output
        err = max_abs_err(torch.from_numpy(got),
                          torch.from_numpy(want[eng.pipeline.name][:len(got)]))
        if err:
            raise AssertionError(f"{label}: batch 0 != the plain chain: max-abs {err}")
        imb = imbalance_pct(stats.cpu.total_ms, stats.accel.total_ms)
        split = (f"; split row {stats.split_row}, halo {stats.halo}"
                 if cfg.approach == 2 else "")
        print(f"[19 {label}] ratio {cfg.gpu_ratio:.4f} batch {cfg.batch_size}: wall "
              f"{stats.wall_ms:.2f} ms, {stats.images_per_sec:.1f} img/s; "
              f"{lane_text('cpu', stats.cpu)}; {lane_text('gpu', stats.accel)}; imbalance "
              f"{imb:.1f}%{split}; {kernel} launches {counts[kernel]} ({batches} batches + "
              f"{warmups} warm-up); max_abs_err {err} over {len(got)} images [{card}]",
              flush=True)
        results[label] = {"wall_ms": stats.wall_ms, "img_per_s": stats.images_per_sec,
                          "kernel": kernel, "launches": counts[kernel], "err": err,
                          "ratio": cfg.gpu_ratio}
        return results[label]

    run("a A1 gpu b500", approach=1, mode="gpu", batch_size=500)
    run("a A1 gpu b35", approach=1, mode="gpu", batch_size=35)
    run("b A1 both 0.5", approach=1, mode="both", gpu_ratio=0.5, batch_size=500)
    run("b A1 both calibrated", approach=1, mode="both", gpu_ratio=calibrate(1),
        batch_size=500)
    run("c A1 both greedy", approach=1, mode="both", scheduler="greedy", batch_size=500)
    run("d A2 0.5", approach=2, gpu_ratio=0.5, batch_size=500)
    run("d A2 calibrated", approach=2, gpu_ratio=calibrate(2), batch_size=500)
    run("e A2 chain", approach=2, gpu_ratio=0.9, batch_size=35, pipeline="chain")

    # (f) the fleet: a host-CPU lane and the card, greedy, 1000 images.
    wrappers = reset_counts()
    fleet = FleetEngine([LaneSpec("cpu", name="cpu"), LaneSpec(dev, name="cuda:0")],
                        approach=1, batch_size=100, num_images=1000, scheduler="greedy")
    fs = fleet.run(stream=SeededStream(distinct, 1000, 100))
    counts = {k: fn.launches for k, fn in wrappers.items()}
    batches, warmups = fs.lanes[1].images // 100, 1
    if counts["K1 rows"] != batches + warmups or any(
            n for k, n in counts.items() if k != "K1 rows"):
        raise AssertionError(f"fleet: launches {counts}, expected K1 rows {batches} + 1")
    err = max_abs_err(torch.from_numpy(fleet.first_output),
                      torch.from_numpy(want["blur3"][:100]))
    if err:
        raise AssertionError(f"fleet: batch 0 != the plain chain: max-abs {err}")
    print(f"[19 f fleet greedy] {len(fs.lanes)} lanes, batch 100, 1000 images: wall "
          f"{fs.wall_ms:.2f} ms, {fs.images_per_sec:.1f} img/s; "
          f"{'; '.join(lane_text(c.name, c) for c in fs.lanes)}; imbalance "
          f"{fs.imbalance_pct():.1f}%; K1 rows launches {counts['K1 rows']} ({batches} "
          f"batches + 1 warm-up); max_abs_err {err} over 100 images [{card}]", flush=True)
    results["f fleet greedy"] = {"wall_ms": fs.wall_ms, "img_per_s": fs.images_per_sec,
                                 "kernel": "K1 rows", "launches": counts["K1 rows"],
                                 "err": err}

    # For the record: one batch of 500 images (115 MB) to the card and back:
    # from and into pageable memory (new host memory each time, as a plain
    # `.to()`/`.cpu()` makes), and from and into reused pinned memory, which
    # the CUDA lane stages through.
    batch = np.ascontiguousarray(distinct)
    pageable = torch.from_numpy(batch)
    pinned = pageable.pin_memory()
    on_card = pageable.to(dev)
    back = torch.empty(batch.shape, dtype=torch.uint8, pin_memory=True)
    xfer = {"h2d pageable": cuda_ms(lambda: pageable.to(dev), reps=5),
            "h2d pinned": cuda_ms(lambda: pinned.to(dev, non_blocking=True), reps=5),
            "d2h pageable": cuda_ms(lambda: on_card.cpu(), reps=5),
            "d2h pinned": cuda_ms(lambda: back.copy_(on_card, non_blocking=True), reps=5)}
    if not (back.is_pinned() and pinned.is_pinned()):
        raise AssertionError("the staging buffers are not pinned")
    gb = batch.nbytes / 1e9
    print(f"[19 transfers] one batch of {A_DISTINCT} images ({batch.nbytes} bytes): "
          + ", ".join(f"{k} {v:.3f} ms ({gb / v * 1e3:.1f} GB/s)" for k, v in xfer.items())
          + f" [{card}]", flush=True)
    del pinned, on_card, back
    secs = time.perf_counter() - t_phase
    print(f"[19 engine] phase {secs:.1f} s [{card}]", flush=True)
    return {"runs": results, "secs": secs, "transfers": xfer,
            "k1_launches": sum(r["launches"] for r in results.values()
                               if r["kernel"] == "K1 rows"),
            "k2_launches": sum(r["launches"] for r in results.values()
                               if r["kernel"] == "K2")}


# Phase 20: the serving options over phase 18's stream.
SERVE_REPS = 3  # timed passes a path, after one warm-up
CMYK_IMAGES = 1000
CPU_IMAGES = 16  # images of each path held against the CPU path


@contextlib.contextmanager
def plain_kernels():
    """While the block runs, K6, K7, K11, K1's rows entry and equalize's
    K8-K10 are their plain versions on the card (in chunks) wherever the
    port calls them: the same path with each kernel replaced, the
    yardstick of phases 18, 20 and 21."""
    from hipe_tpu_torch.models import pipelines as plib
    from hipe_tpu_torch.ops import jpeg_decode as jd
    from hipe_tpu_torch.ops import jpeg_encode as je

    def idct(coefs, q):
        return chunked(jd.idct8x8_islow, coefs, q)

    def fdct(grid, q):
        return chunked(je.fdct_quantize_plain, grid, q)

    def rows_blur(rows, c, r, h_pad=True, rows_per_block=None, out=None):
        y = plain_rows_chunked(rows, c, (f"gaussian{2 * r + 1}",), h_pad)
        return y if out is None else out.copy_(y)

    def ycc_rows(*args, out=None):
        y = jd.ycc_rows_plain(*args)
        return y if out is None else out.copy_(y)

    saved = (jd.dequant_idct_cuda, jd.ycc_rows_cuda, je.fdct_quantize_cuda,
             plib.gaussian_blur_rows_cuda)
    (jd.dequant_idct_cuda, jd.ycc_rows_cuda, je.fdct_quantize_cuda,
     plib.gaussian_blur_rows_cuda) = (idct, ycc_rows, fdct, rows_blur)
    try:
        with plain_equalize():
            yield
    finally:
        (jd.dequant_idct_cuda, jd.ycc_rows_cuda, je.fdct_quantize_cuda,
         plib.gaussian_blur_rows_cuda) = saved


# Planes a call of equalize's plain stages on the card: the int64 index of
# 1000 planes of 256x256 is 524 MB.
PLAIN_EQUALIZE_PLANES = 1000


def plain_equalize_stages() -> dict:
    """K8, K9 and K10's plain versions on the card, in chunks of planes
    (each stage's torch ops, as ``ops/equalize.py`` runs them on the CPU)."""
    from hipe_tpu_torch.ops import equalize as eq

    def each(fn, out, *parts):
        res = torch.cat([fn(*chunk) for chunk in zip(*[p.split(PLAIN_EQUALIZE_PLANES)
                                                      for p in parts])])
        return res if out is None else out.copy_(res)

    return {
        "K8": lambda planes, out=None: each(eq.histogram_planes, out, planes),
        "K9": lambda hist, npix, out=None: eq.equalize_lut(hist, npix) if out is None
        else out.copy_(eq.equalize_lut(hist, npix)),
        "K10": lambda planes, lut, out=None: each(eq.apply_lut, out, planes, lut),
    }


@contextlib.contextmanager
def plain_equalize():
    """While the block runs, K8, K9 and K10 are their plain versions on the
    card wherever equalize calls them."""
    from hipe_tpu_torch.ops import cuda_equalize as ce

    plain = plain_equalize_stages()
    saved = ce.histogram_planes_cuda, ce.equalize_lut_cuda, ce.apply_lut_planar_cuda
    ce.histogram_planes_cuda, ce.equalize_lut_cuda, ce.apply_lut_planar_cuda = (
        plain["K8"], plain["K9"], plain["K10"])
    try:
        yield
    finally:
        ce.histogram_planes_cuda, ce.equalize_lut_cuda, ce.apply_lut_planar_cuda = saved


def outputs_err(got, want) -> int:
    """Max-abs error over a tensor or a list of tensors."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs against {len(want)}")
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def drive_serving_path(card: str, label: str, fn, inputs, cpu_fn, per_pass: dict,
                       phase: str = "20 serving options") -> dict:
    """One path of phase 20 (or 21): SERVE_REPS timed passes after a warm-up and one
    kept pass, the launches over them alone (exactly ``per_pass`` a pass,
    no other kernel), the kept pass against the same path on the plain
    kernels and its first CPU_IMAGES images against ``cpu_fn`` on CPU
    tensors. Raises on any difference."""
    per_pass = {k: v for k, v in per_pass.items() if v}
    wrappers = reset_counts()
    ms = cuda_ms(lambda: fn(*inputs), reps=SERVE_REPS)
    got = fn(*inputs)
    torch.cuda.synchronize()
    runs = SERVE_REPS + 2
    counts = check_counts(wrappers, {k: v * runs for k, v in per_pass.items()}, label,
                          exact=True)
    with plain_kernels():
        want = fn(*inputs)
    err = outputs_err(got, want)
    del want
    cpu_err = outputs_err([g[:CPU_IMAGES].cpu() for g in (got if isinstance(got, (list, tuple))
                                                         else [got])],
                          cpu_fn(*[x[:CPU_IMAGES].cpu() for x in inputs]))
    if err or cpu_err:
        raise AssertionError(f"{label}: max-abs {err} against the plain kernels, {cpu_err} "
                             "against the CPU path")
    launched = {k: n for k, n in counts.items() if n}
    print(f"[{phase}] {label}: {ms:.4f} ms a pass over {inputs[0].shape[0]} images; "
          f"launches {launched} over {runs} passes; max_abs_err {err} against the plain "
          f"kernels, {cpu_err} against the CPU path on the first {CPU_IMAGES} images "
          f"[{card}]", flush=True)
    return {"ms": ms, "counts": counts, "err": err}


def cmyk_coefficients(image4: torch.Tensor, color: int, qtables: list, count: int):
    """(geometry, per-component coefficients) of ``count`` copies of a
    256x256 4-component image, made by K7 from its four planes: CMYK (4)
    with every component at full resolution, YCCK (5) with libjpeg's
    sampling (2x2, 1x1, 1x1, 2x2; the middle two averaged 2x2 first)."""
    from hipe_tpu_torch.ops import jpeg_decode as jd
    from hipe_tpu_torch.ops import jpeg_encode as je

    samp = ((1, 1),) * 4 if color == 4 else ((2, 2), (1, 1), (1, 1), (2, 2))
    max_h, max_v = max(h for h, _ in samp), max(v for _, v in samp)
    comps, coefs = [], []
    for ci, (h, v) in enumerate(samp):
        plane = image4[..., ci]
        if (h, v) != (max_h, max_v):
            plane = je.downsample_h2v2(plane.to(torch.int32)).to(torch.uint8)
        c = je.fdct_quantize(plane[None], qtables[ci])
        coefs.append(c.expand(count, *c.shape[1:]).contiguous())
        comps.append((h, v, c.shape[2], c.shape[1]))
    geo = jd.DecodeGeometry(width=image4.shape[1], height=image4.shape[0], ncomps=4,
                            comps=tuple(comps), max_h=max_h, max_v=max_v, color=color)
    return geo, coefs


def phase_serving_options(card: str) -> dict:
    """Phase 20: the serving options, CMYK/YCCK decode and the lossless
    transforms over phase 18's stream; the launches of K6, K7 and K1's rows
    entry over the phase's paths."""
    from hipe_tpu_torch.io_ import jpeg as jio
    from hipe_tpu_torch.ops import jpeg_decode as jd
    from hipe_tpu_torch.ops import jpeg_encode as je
    from hipe_tpu_torch.ops import jpeg_transform as jt
    from hipe_tpu_torch.ops.equalize import colorize_lut
    from hipe_tpu_torch.runtime.serve import ServingPipeline
    from hipe_tpu_torch.utils.images import checker_image

    t_phase = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    image = checker_image(SIDE, SIDE, CHANNELS, seed=0)
    geo = je.encode_geometry(SIDE, SIDE, CHANNELS, "420")
    luma, chroma = jio.quality_tables(90)
    qt = [luma, chroma, chroma]
    qkey = tuple(tuple(int(v) for v in q) for q in qt)
    one = torch.from_numpy(image).to(dev)[None]
    coefs = tuple(c.expand(NUM_IMAGES, *c.shape[1:]).contiguous()
                  for c in je.encode_planes(geo, one, qt))
    lut = colorize_lut("#000080", "#ffe0a0", "#800000")
    options = {
        "decode_scale=2": {"decode_scale": 2},
        "decode_scale=4": {"decode_scale": 4},
        "decode_scale=8": {"decode_scale": 8},
        "decode_gray": {"decode_gray": True},
        "gray_output": {"gray_output": True},
        "output_scale=2": {"output_scale": 2},
        "resize_to=(144, 200)": {"resize_to": (144, 200)},
        "decode_gray + colorize": {"decode_gray": True, "colorize": lut},
    }
    totals = {"K6": 0, "K11": 0, "K7": 0, "K1 rows": 0}
    paths = {}

    def add(label: str, res: dict) -> None:
        paths[label] = res
        for k in totals:
            totals[k] += res["counts"][k]

    for name, opts in options.items():
        sps = [ServingPipeline("blur3", device=d, decode_on_device=True, encode_on_device=True,
                               **opts) for d in (dev, cpu)]
        g, q = sps[0]._maybe_gray_geo(geo, qkey)
        k6 = sum(size == 8 for size in jd.scaled_sizes(g, sps[0].decode_scale))
        k11 = int(jd.ycc_rows_fancy(g, sps[0].decode_scale) is not None)
        k7 = sps[0]._out_c(3 if g.ncomps == 3 else 1)
        ins = coefs[:g.ncomps]
        add(f"{name} decode + blur3", drive_serving_path(
            card, f"{name} decode + blur3", sps[0].decode_filter_fn(g, q), ins,
            sps[1].decode_filter_fn(g, q), {"K6": k6, "K11": k11, "K1 rows": 1}))
        add(f"{name} transcode", drive_serving_path(
            card, f"{name} transcode", sps[0].transcode_fn(g, q), ins,
            sps[1].transcode_fn(g, q), {"K6": k6, "K11": k11, "K1 rows": 1, "K7": k7}))
        for sp in sps:
            sp.close()
    image4 = torch.from_numpy(checker_image(SIDE, SIDE, 4, seed=1)).to(dev)
    qt4 = [luma, chroma, chroma, luma]
    for color, label in ((4, "CMYK"), (5, "YCCK")):
        g4, c4 = cmyk_coefficients(image4, color, qt4, CMYK_IMAGES)

        def decode4(*c, g4=g4):
            return jd.decode_planes(g4, list(c), qt4, layout="rows")

        add(f"{label} decode", drive_serving_path(card, f"{label} decode {g4.comps}", decode4, c4,
                                                  decode4, {"K6": 4}))
        del c4
    for op in jt.OPS:
        def transform(*c, op=op):
            return [jt.transform_component(x, op) for x in c]

        add(f"transform {op}", drive_serving_path(card, f"transform {op}", transform, coefs,
                                                  transform, {}))
    back = coefs
    for _ in range(4):
        back = [jt.transform_component(x, "rot90") for x in back]
    if outputs_err(back, coefs):
        raise AssertionError("four rot90 transforms on the card are not the identity")
    found = libjpeg_found()
    if "jpeglib.h found" in found and "libjpeg absent" not in found:
        from hipe_tpu_torch import cli

        if cli.main(["serve", "blur3", "--decode-scale", "4", "--gray", "--decode-on-device",
                     "--encode-on-device", "--num-images", "8", "--batch-size", "4"]) != 0:
            raise AssertionError("serve --decode-scale 4 --gray failed")
        data = jio.encode_bytes(image, 90)
        turned = jt.transform_bytes(jt.transform_bytes(data, "rot90"), "rot270")
        for a, b in zip(jio.read_coefficients(turned).components,
                        jio.read_coefficients(data).components):
            if not np.array_equal(a.coefs, b.coefs):
                raise AssertionError("transform rot90 then rot270 changed the coefficients")
        print(f"[20 serving options] byte level: serve --decode-scale 4 --gray and a transform "
              f"rot90/rot270 round trip ran, coefficients equal [{card}]", flush=True)
    else:
        print(f"[20 serving options] byte level not run: {found} on this machine; the host "
              "entropy layer needs libjpeg, so serve --decode-scale 4 --gray and the "
              f"transform rot90 round trip run only where it is installed [{card}]", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"[20 serving options] launches over the phase's paths {totals}; phase {secs:.1f} s "
          f"[{card}]", flush=True)
    del coefs, back, image4
    torch.cuda.empty_cache()
    return {"paths": paths, "launches": totals, "secs": secs}


# Phase 21: the global-statistics family.
STATS_PATHS = (("equalize", {}), ("autocontrast", {}), ("autocontrast", {"cutoff": 2}),
               ("autocontrast", {"preserve_tone": True}), ("contrast", {"factor": 1.5}),
               ("color", {"factor": 2.2}), ("sharpness", {"factor": 2.0}), ("mode", {}),
               ("mode5", {}))
# Chained passes a timing of each path (3 timings after as many warm-up passes).
STATS_PASSES = 5
# The least ms of passes over which a path's idle share is read.
STATS_BUSY_MS = 100
# Times the stream's bytes a pass must move: equalize, autocontrast and
# contrast read it for their statistics, then read and write it; color and
# mode read and write it; sharpness reads and writes it through K3 (the
# SMOOTH plane), then reads it and the SMOOTH plane and writes the blend.
STATS_STREAM_BYTES = {"equalize": 3, "autocontrast": 3, "contrast": 3, "color": 2,
                      "sharpness": 5, "mode": 2, "mode5": 2}
STATS_BATCH = 64  # varied 256x256 images held against the NumPy oracles
STATS_KINDS = ("uniform", "lowrange", "skewed", "constant", "twovals", "sparse", "overflow",
               "levels", "float_quirk")


def stats_image(kind: str, seed: int) -> np.ndarray:
    """A 256x256x3 image of one of tests/test_equalize.py's kinds (its 8x8
    "tiny" case, step 0, as "sparse": fewer than 255 pixels off the last
    bin), quantized levels (real modes) and autocontrast's float64 quirk."""
    rng = np.random.default_rng(seed)
    shape = (SIDE, SIDE, CHANNELS)
    if kind == "uniform":
        return rng.integers(0, 256, shape, np.uint8)
    if kind == "lowrange":
        return rng.integers(90, 110, shape, np.uint8)
    if kind == "skewed":
        return np.clip(rng.normal(40, 12, shape), 0, 255).astype(np.uint8)
    if kind == "constant":
        return np.full(shape, 77, np.uint8)
    if kind == "twovals":
        return np.where(rng.random(shape) < 0.7, 10, 200).astype(np.uint8)
    if kind == "levels":
        return (rng.integers(0, 4, shape) * 85).astype(np.uint8)
    if kind == "float_quirk":
        img = rng.integers(26, 34, shape).astype(np.uint8)
        img[0, 0], img[0, 1] = 26, 33
        return img
    img = np.full(shape, 200, np.uint8)
    flat = img.reshape(-1, CHANNELS)
    count = 100 if kind == "sparse" else 5536  # "overflow": raw LUT values past 255
    idx = rng.choice(len(flat), count, replace=False)
    flat[idx] = rng.integers(0, 21, (count, CHANNELS)).astype(np.uint8)
    return img


@contextlib.contextmanager
def plain_k3():
    """While the block runs, K3 is its plain version on the card (in chunks)
    wherever the port's route calls it: sharpness's SMOOTH plane on the plain
    chain."""
    from hipe_tpu_torch.ops import planar

    def plain(x, names, h_pad=True, rows_per_block=None, out=None):
        y = plain_chunked(x, tuple(names), h_pad)
        return y if out is None else out.copy_(y)

    saved = planar.rank_chain_planar_cuda
    planar.rank_chain_planar_cuda = plain
    try:
        yield
    finally:
        planar.rank_chain_planar_cuda = saved


def oracle_err(pipe, batch: np.ndarray, got: torch.Tensor) -> int:
    """Max-abs error of ``got`` (planar, on the card) against the pipeline's
    NumPy oracle on each image of ``batch``, the oracles in threads."""
    from concurrent.futures import ThreadPoolExecutor

    from hipe_tpu_torch.utils.images import hwc_to_planar

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        want = np.stack(list(pool.map(pipe.oracle, batch)))
    return max_abs_err(got, torch.from_numpy(hwc_to_planar(want)).to(got.device))


EQUALIZE_KERNELS = ("K8", "K9", "K10")
# The benchmark's resident stream (its configuration and image generator).
BENCH_STREAM_CONFIG = "torch_bench/configs/resident_5000x320x240_rgb.json"
BENCH_STREAM_GEN = "torch_bench/gen/photo_like.py"


def bench_stream_planes(seed: int) -> torch.Tensor:
    """The benchmark's planar (15000, 240, 320) uint8 stream of ``seed`` on
    the card, made by its own photo-like generator."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, BENCH_STREAM_CONFIG)) as f:
        cfg = json.load(f)
    spec = importlib.util.spec_from_file_location("photo_like",
                                                  os.path.join(root, BENCH_STREAM_GEN))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    shape = (cfg["num_images"], cfg["height"], cfg["width"], cfg["channels"])
    return gen.planar(0, shape[0], shape, seed, cfg["images"], torch.device("cuda"))


def equalize_kernels(card: str, planes: torch.Tensor) -> dict:
    """Equalize's K8, K9 and K10 each alone over the stream ``planes``: ms
    a launch (CUDA events, the mean of PASSES after a warm-up), its bound
    (the bytes it must move over the card's 3.35 TB/s), its plain version's
    ms on the card (in chunks) and its output against the plain version's;
    and a copy of ``planes`` (``copy_``), K10's nearest library yardstick."""
    from hipe_tpu_torch.ops import cuda_equalize as ce

    n, h, w = planes.shape
    plain = plain_equalize_stages()
    hist = ce.histogram_planes_cuda(planes)
    lut = ce.equalize_lut_cuda(hist, h * w)
    out = torch.empty_like(planes)
    calls = {  # kernel, plain version, bytes: the planes, 1 KB of counts, 256 B of table
        "K8": (lambda: ce.histogram_planes_cuda(planes, out=hist),
               lambda: plain["K8"](planes), n * h * w + n * 1024),
        "K9": (lambda: ce.equalize_lut_cuda(hist, h * w, out=lut),
               lambda: plain["K9"](hist, h * w), n * 1024 + n * 256),
        "K10": (lambda: ce.apply_lut_planar_cuda(planes, lut, out=out),
                lambda: plain["K10"](planes, lut), 2 * n * h * w + n * 256),
    }
    res = {}
    for k, (fn, plain_fn, nbytes) in calls.items():
        ms = cuda_ms(fn, reps=PASSES)
        plain_ms = cuda_ms(plain_fn)
        err = max_abs_err(fn(), plain_fn())
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if err:
            raise AssertionError(f"{k}: max-abs {err} against its plain version")
        print(f"[21 global stats] equalize {k} alone over {n}x{h}x{w}: {ms:.4f} ms a launch; "
              f"bound {bound_ms:.4f} ms (bytes); plain {plain_ms:.4f} ms; max_abs_err {err} "
              f"against the plain version [{card}]", flush=True)
        res[k] = {"ms": ms, "bound_ms": bound_ms, "bound_by": "bytes", "plain_ms": plain_ms,
                  "err": err}
    res["K10"]["copy_ms"] = cuda_ms(lambda: out.copy_(planes), reps=PASSES)
    print(f"[21 global stats] copy_ over {n}x{h}x{w}: {res['K10']['copy_ms']:.4f} ms [{card}]",
          flush=True)
    return res


def k12_ptxas() -> dict:
    """(registers, spill stores, spill loads, stack frame) of K12's two
    instantiations (mode_planar_kernel<1>, <2>) in the build log."""
    import re

    from hipe_tpu_torch.ops import _build

    log = (_build.build_dir() / "build.log").read_text()
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        m = re.search(r"mode_planar_kernelILi(\d)E", entry.split("\n")[0])
        if m:
            out[f"r{m.group(1)}"] = ptxas_numbers(entry)
    return out


def mode_kernel(card: str, planes: torch.Tensor) -> dict:
    """K12 alone over the stream ``planes`` at both sizes: ms a launch (CUDA
    events, the mean of PASSES after a warm-up), its bound (the stream read
    once and written once over the card's 3.35 TB/s), its plain version's
    ms on the card (the pairwise form, in the CPU route's chunks) and its
    output against the plain version's; and K12's ptxas report, which fails
    on a spill or a stack frame."""
    from hipe_tpu_torch.models.pipelines import global_stats_chunk
    from hipe_tpu_torch.ops import cuda_mode as cm
    from hipe_tpu_torch.ops import equalize as eq

    ptxas = k12_ptxas()
    if sorted(ptxas) != ["r1", "r2"] or any(v[1:] != (0, 0, 0) for v in ptxas.values()):
        raise AssertionError(f"K12's ptxas report missing, or spills or a stack frame "
                             f"(registers, spill stores, spill loads, stack frame): {ptxas}")
    n, h, w = planes.shape
    out, ref = torch.empty_like(planes), torch.empty_like(planes)
    res = {"ptxas": ptxas}
    for size, name in ((3, "mode"), (5, "mode5")):
        k = global_stats_chunk(h, w, CHANNELS, name, "cpu")

        def plain():
            for i in range(0, n, k):
                ref[i:i + k] = eq.mode_plain(planes[i:i + k], size)
            return ref

        ms = cuda_ms(lambda: cm.mode_planar_cuda(planes, size, out=out), reps=PASSES)
        plain_ms = cuda_ms(plain)
        err = max_abs_err(cm.mode_planar_cuda(planes, size, out=out), plain())
        bound_ms = 2 * n * h * w / HBM_BYTES_PER_S * 1e3
        if err:
            raise AssertionError(f"K12 {name}: max-abs {err} against its plain version")
        print(f"[21 global stats] {name} K12 alone over {n}x{h}x{w}: {ms:.4f} ms a launch; "
              f"bound {bound_ms:.4f} ms (bytes); plain {plain_ms:.4f} ms; max_abs_err {err} "
              f"against the plain version; ptxas r{size // 2} (registers, spill stores, "
              f"spill loads, stack frame) {ptxas[f'r{size // 2}']} [{card}]", flush=True)
        res[name] = {"shape": [n, h, w], "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
                     "plain_ms": plain_ms, "err": err}
    return res


def phase_global_stats(card: str) -> dict:
    """Phase 21: the global-statistics family over the 5000-image stream,
    a varied batch against the NumPy oracles, the engine and three serving
    paths; K3's launches (sharpness) and K6's and K7's (serving)."""
    from hipe_tpu_torch.io_.jpeg import quality_tables
    from hipe_tpu_torch.models.pipelines import GlobalStatsPipeline, global_stats_chunk
    from hipe_tpu_torch.ops import jpeg_encode as je
    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu_torch.runtime.engine import Engine, EngineConfig
    from hipe_tpu_torch.runtime.serve import ServingPipeline
    from hipe_tpu_torch.utils.images import checker_image, hwc_to_planar

    t_phase = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    kernels, equalize_launches, equalize_runs = {}, {}, 0
    k12, k12_launches = {}, {}
    batch = np.stack([stats_image(STATS_KINDS[i % len(STATS_KINDS)], seed=i)
                      for i in range(STATS_BATCH)])
    batch_planes = torch.from_numpy(hwc_to_planar(batch)).to(dev)
    paths = {}
    k3_launches = 0
    for name, params in STATS_PATHS:
        t_path = time.perf_counter()
        pipe = GlobalStatsPipeline(name, **params)
        label = name + "".join(f" {k}={v}" for k, v in params.items())
        wrappers = reset_counts()
        runner = DeviceStreamRunner(pipe, num_images=NUM_IMAGES, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        err = runner.verify_max_abs_err()  # the first image against the NumPy oracle
        passes = STATS_PASSES
        ms = runner.measure_throughput(passes=passes, reps=3)["per_pass_s"] * 1e3
        kept = runner.run_passes(1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        runs = 1 + 4 * passes + 1  # verify, warm-up and 3 timings, the kept pass
        chunks = -(-runner.stream.shape[0] // global_stats_chunk(SIDE, SIDE, CHANNELS, name,
                                                                  dev))
        own = {"sharpness": ("K3",), "equalize": EQUALIZE_KERNELS, "mode": ("K12",),
               "mode5": ("K12",)}.get(name, ())
        expect = {k: chunks * runs for k in own}
        counts = check_counts(wrappers, expect, label)
        if any(counts[k] != n for k, n in expect.items()):
            raise AssertionError(f"{label}: launches {counts}, expected {chunks} chunks x "
                                 f"{runs} passes of each of {own}")
        k3_launches += counts["K3"]
        if name == "equalize":
            equalize_launches, equalize_runs = {k: counts[k] for k in EQUALIZE_KERNELS}, runs
            kernels = equalize_kernels(card, runner.stream)
            bench = bench_stream_planes(seed=21)
            for k, v in equalize_kernels(card, bench).items():
                kernels[k]["bench_stream"] = {"shape": list(bench.shape), **v}
            del bench
        if name in ("mode", "mode5"):
            # Launches a pass of the stream, as counted over its passes.
            per_pass, rest = divmod(counts["K12"], runs)
            if rest:
                raise AssertionError(f"{name} K12: {counts['K12']} launches over {runs} "
                                     "stream passes is no whole number a pass")
            k12_launches[name] = {"stream_launches": counts["K12"], "launches_per_pass": per_pass}
        if name == "mode5":
            bench = bench_stream_planes(seed=21)
            k12 = mode_kernel(card, bench)
            del bench
        head = CPU_IMAGES * CHANNELS
        cpu_err = max_abs_err(kept[:head].cpu(), pipe.apply_planar(runner.stream[:head].cpu()))
        plain_err = None
        if name == "sharpness":
            with plain_k3():
                plain_err = max_abs_err(kept, runner.run_passes(1))
        # At least STATS_BUSY_MS of passes: a few milliseconds of them (an
        # equalize pass is ~1 ms, a mode pass on K12 ~6) is too short a window
        # for torch.profiler to record their kernels reliably.
        busy_passes = max(passes, int(STATS_BUSY_MS / ms) + 1)
        busy = device_busy(lambda: runner.run_passes(busy_passes))
        del kept, runner
        torch.cuda.empty_cache()
        varied = pipe.apply_planar(batch_planes)
        if name.startswith("mode"):
            # The mode oracle moves some 2-5 GB of host memory a plane: the
            # first channel of one image of each kind against it, and the
            # whole batch against the CPU path.
            n = len(STATS_KINDS)
            batch_err = max(oracle_err(pipe, batch[:n, ..., :1], varied[:n * CHANNELS:CHANNELS]),
                            max_abs_err(varied.cpu(), pipe.apply_planar(batch_planes.cpu())))
        else:
            n = STATS_BATCH
            batch_err = oracle_err(pipe, batch, varied)
        del varied
        worst = max(err, cpu_err, batch_err, plain_err or 0)
        if worst:
            raise AssertionError(f"{label}: max-abs {err} (first image against the oracle), "
                                 f"{cpu_err} (first {CPU_IMAGES} against the CPU), "
                                 f"{batch_err} (varied batch against the oracles), "
                                 f"{plain_err} (against plain K3)")
        pixels = NUM_IMAGES * SIDE * SIDE * CHANNELS
        bound_ms, bound_by = STATS_STREAM_BYTES[name] * pixels / HBM_BYTES_PER_S * 1e3, "bytes"
        launched = {k: n for k, n in counts.items() if n}
        print(f"[21 global stats] {label}: {ms:.4f} ms a pass ({passes} passes, median of 3), "
              f"{NUM_IMAGES * 1e3 / ms:.1f} img/s; bound {bound_ms:.4f} ms ({bound_by}); "
              f"{chunks} chunks; peak memory {peak / 1e9:.3f} GB ({resident / 1e9:.3f} GB "
              f"resident); device idle over {busy_passes} passes "
              f"{1 - busy[1] / busy[0]:.2%}; launches "
              f"{launched or 'none'} over {runs} passes; max_abs_err {err} (first image "
              f"against the oracle), {cpu_err} (first {CPU_IMAGES} against the CPU), "
              f"{batch_err} ({STATS_BATCH} varied images against the "
              + ("oracles" if n == STATS_BATCH else f"CPU, a plane of {n} against the oracle")
              + ")"
              + ("" if plain_err is None else f", {plain_err} (against plain K3)")
              + f"; path {time.perf_counter() - t_path:.1f} s [{card}]", flush=True)
        paths[label] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "peak": peak,
                        "idle": 1 - busy[1] / busy[0], "err": worst, "counts": counts}
    del batch_planes

    # The engine: approach 1 'gpu' at batch 500 with equalize over phase 19's stream.
    t_path = time.perf_counter()
    distinct = np.random.default_rng(19).integers(0, 256, (A_DISTINCT, A_H, A_W, CHANNELS),
                                                  dtype=np.uint8)
    wrappers = reset_counts()
    eng = Engine(EngineConfig(approach=1, mode="gpu", batch_size=500, num_images=NUM_IMAGES,
                              pipeline="equalize"))
    stats = eng.run(stream=SeededStream(distinct, NUM_IMAGES, 500))
    # At least one launch of each a CUDA-lane batch.
    counts = check_counts(wrappers, {k: NUM_IMAGES // 500 for k in EQUALIZE_KERNELS},
                          "engine equalize")
    pipe = GlobalStatsPipeline("equalize")
    engine_err = oracle_err(pipe, distinct, torch.from_numpy(
        hwc_to_planar(eng.first_output)).to(dev))
    if engine_err:
        raise AssertionError(f"engine equalize: batch 0 != the oracle: max-abs {engine_err}")
    print(f"[21 engine] A1 gpu b500 equalize, {NUM_IMAGES} images of {A_W}x{A_H}x{CHANNELS}: "
          f"wall {stats.wall_ms:.2f} ms, {stats.images_per_sec:.1f} img/s; "
          f"{lane_text('gpu', stats.accel)}; launches "
          f"{ {k: n for k, n in counts.items() if n} }; max_abs_err "
          f"{engine_err} over batch 0 ({A_DISTINCT} images) against the oracle; "
          f"{time.perf_counter() - t_path:.1f} s [{card}]", flush=True)
    engine = {"wall_ms": stats.wall_ms, "img_per_s": stats.images_per_sec, "err": engine_err,
              "counts": counts}
    del eng, distinct

    # Serving: decode + filter and the transcode over phase 18's stream.
    geo = je.encode_geometry(SIDE, SIDE, CHANNELS, "420")
    luma, chroma = quality_tables(90)
    qt = [luma, chroma, chroma]
    qkey = tuple(tuple(int(v) for v in q) for q in qt)
    one = torch.from_numpy(checker_image(SIDE, SIDE, CHANNELS, seed=0)).to(dev)[None]
    coefs = tuple(c.expand(NUM_IMAGES, *c.shape[1:]).contiguous()
                  for c in je.encode_planes(geo, one, qt))
    serving = {}
    totals = {"K6": 0, "K11": 0, "K7": 0, **{k: 0 for k in EQUALIZE_KERNELS}}
    for name, params in (("equalize", {}), ("autocontrast", {"cutoff": 2}),
                         ("contrast", {"factor": 1.5})):
        pipe = GlobalStatsPipeline(name, **params)
        label = name + "".join(f" {k}={v}" for k, v in params.items())
        sps = [ServingPipeline(pipe, device=d, decode_on_device=True, encode_on_device=True)
               for d in (dev, cpu)]
        own = {k: 1 for k in EQUALIZE_KERNELS} if name == "equalize" else {}
        for what, per_pass in (("decode_filter_fn", {"K6": 3, "K11": 1, **own}),
                               ("transcode_fn", {"K6": 3, "K11": 1, "K7": 3, **own})):
            res = drive_serving_path(card, f"{label} {what}", getattr(sps[0], what)(geo, qkey),
                                     coefs, getattr(sps[1], what)(geo, qkey), per_pass,
                                     phase="21 global stats")
            serving[f"{label} {what}"] = res
            for k in totals:
                totals[k] += res["counts"][k]
        for sp in sps:
            sp.close()
    del coefs
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"[21 global stats] launches over the phase's paths: K3 {k3_launches}, {totals}; "
          f"phase {secs:.1f} s [{card}]", flush=True)
    for k in EQUALIZE_KERNELS:
        kernels[k]["launches"] = (equalize_launches[k] + engine["counts"][k] + totals[k])
        kernels[k]["stream_launches"] = equalize_launches[k]
        # Launches a pass of the stream, as counted over its passes.
        per_pass, rest = divmod(equalize_launches[k], equalize_runs)
        if rest:
            raise AssertionError(f"equalize {k}: {equalize_launches[k]} launches over "
                                 f"{equalize_runs} stream passes is no whole number a pass")
        kernels[k]["launches_per_pass"] = per_pass
    for name, v in k12_launches.items():
        k12[name].update(v)
    return {"paths": paths, "engine": engine, "serving": serving, "kernels": kernels,
            "k12": k12, "launches": {"K3": k3_launches, **totals}, "secs": secs}


def main() -> int:
    from hipe_tpu_torch.ops.blur import FILTER_RADIUS, GAUSSIANS
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_rows_cuda
    from hipe_tpu_torch.ops.cuda_chain import filter_chain_rows_cuda
    from hipe_tpu_torch.ops.cuda_tiled import (filter_stage_planar_tiled_cuda,
                                               gaussian_blur_planar_tiled_cuda)

    card = phase_env()
    phase_build(card)
    k1_err = phase_kernel_vs_plain(card)
    k2_err = phase_k2_vs_plain(card)
    k3_err = phase_k3_vs_plain(card)
    blur3 = phase_main_path(card, "6", "blur3")
    k1_bench = phase_k1_bench_stream(card)
    chain = phase_main_path(card, "7", "chain")
    denoise = phase_main_path(card, "8", "denoise")
    k1_rows_err = phase_rows_vs_plain(
        card, "9", "K1 rows",
        lambda x, c, names, **kw: gaussian_blur_rows_cuda(
            x, c, FILTER_RADIUS[names[0]], **kw),
        gaussian_blur_rows_cuda, tuple((g,) for g in GAUSSIANS), seed=3,
        channels=K1_ROWS_CHANNELS, offsets=(0, 1))
    # K2's rows entry keeps its first design, its chains (not the 32-stage
    # one that tests the planar entry's halo) and its rows shapes.
    k2_rows_err = phase_rows_vs_plain(card, "10", "K2 rows", filter_chain_rows_cuda,
                                      filter_chain_rows_cuda, K2_CHAINS[:-1], seed=4,
                                      shapes=ROWS_SHAPES[:3], record=True)
    k4_err, k4_stream_ms = phase_tiled_vs_plain(
        card, "11", "K4",
        lambda x, name, **kw: gaussian_blur_planar_tiled_cuda(x, FILTER_RADIUS[name], **kw),
        gaussian_blur_planar_tiled_cuda, GAUSSIANS, seed=5, record="gaussian3")
    k5_err, _ = phase_tiled_vs_plain(card, "12", "K5", filter_stage_planar_tiled_cuda,
                                     filter_stage_planar_tiled_cuda, K5_STAGES, seed=6)
    rows = phase_rows_main_path(card)
    large_chain = phase_large_frames(card, "chain")
    large_blur3 = phase_large_frames(card, "blur3")
    k4, k5 = large_chain["own"]["K4"], large_chain["own"]["K5"]
    dct_ptxas = phase_dct_build(card)
    k6_err = phase_k6_vs_plain(card)
    k7_err = phase_k7_vs_plain(card)
    codec = phase_codec_main_paths(card)
    engine = phase_engine(card)
    serving = phase_serving_options(card)
    stats = phase_global_stats(card)
    transcode = codec["paths"]["transcode"]
    codec_err = max(p["err"] for p in codec["paths"].values())
    # No PyTorch call computes these functions: none takes uint8 planes with
    # clamp-to-edge borders and truncating integer arithmetic (conv2d takes
    # float with zero padding; nothing computes a rank window), and none
    # computes libjpeg's integer islow DCTs with their rounding and wrap.
    no_library = None
    print(json.dumps({"kernels": [{
        "name": "blur_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/blur_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:109",
        "also_replaces": ["hipe_tpu/ops/pallas_blur.py:56",
                          "hipe_tpu/ops/pallas_blur.py:923 (single-gaussian chains)",
                          "hipe_tpu/ops/pallas_blur.py:566 (rows entry)"],
        "launches": (blur3["launches"] + rows["launches"] + transcode["counts"]["K1 rows"]
                     + large_blur3["counts"]["K1"] + serving["launches"]["K1 rows"]),
        "max_abs_err": max(k1_err, blur3["chain_err"], k1_rows_err, rows["chain_err"],
                           codec_err, large_blur3["chain_err"], k1_bench["err"]),
        "ms": blur3["ms"],
        "plain_ms": blur3["plain_ms"],
        "bound_ms": blur3["bound_ms"],
        "bound_by": blur3["bound_by"],
        "library_ms": no_library,
        "rows_launches": rows["launches"],
        "transcode_launches": transcode["counts"]["K1 rows"],
        "rows_ms": rows["ms"],
        "rows_plain_ms": rows["plain_ms"],
        # Yardsticks the port never calls: a copy of each stream, and K4 at
        # its best tile over the same 5000-image planar stream (phase 11).
        "copy_ms": blur3["copy_ms"],
        "rows_copy_ms": rows["copy_ms"],
        "k4_stream_ms": k4_stream_ms,
        # blur3 over the 100 frames of 4000x2250 (phase 14), beside K4 at its
        # best tile on the same frames.
        "large_launches": large_blur3["counts"]["K1"],
        "large_ms": large_blur3["own"]["K1"]["ms"],
        "large_k4_ms": large_blur3["other_ms"],
        "device_idle": blur3["idle"],
        # Phase 6: K1 alone over the benchmark's 15000x240x320 stream, beside
        # its copy_.
        "bench_stream": k1_bench,
        # Phase 19: K1's rows entry on the engine's CUDA lane, every blur3 run.
        "engine_launches": engine["k1_launches"],
        # Phase 20: K1's rows entry on every serving-option path (in launches).
        "serving_options_launches": serving["launches"]["K1 rows"],
    }, {
        "name": "chain_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/chain_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:923",
        "also_replaces": ["hipe_tpu/ops/pallas_blur.py:902 (rows entry)"],
        "launches": chain["launches"],
        "max_abs_err": max(k2_err, chain["chain_err"], k2_rows_err),
        "ms": chain["ms"],
        "plain_ms": chain["plain_ms"],
        "bound_ms": chain["bound_ms"],
        "bound_by": chain["bound_by"],
        "library_ms": no_library,
        "device_idle": chain["idle"],
        # Phase 19: K2 after the relayout on the engine's CUDA lane (A2 chain).
        "engine_launches": engine["k2_launches"],
    }, {
        "name": "rank_chain_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/rank_chain_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:273",
        "launches": denoise["launches"] + stats["launches"]["K3"],
        # Phase 21: sharpness's SMOOTH plane, a launch a chunk of a pass.
        "global_stats_launches": stats["launches"]["K3"],
        "max_abs_err": max(k3_err, denoise["chain_err"],
                           stats["paths"]["sharpness factor=2.0"]["err"]),
        "ms": denoise["ms"],
        "plain_ms": denoise["plain_ms"],
        "bound_ms": denoise["bound_ms"],
        "bound_by": denoise["bound_by"],
        "library_ms": no_library,
        "device_idle": denoise["idle"],
    }, {
        "name": "tiled_blur_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/tiled_blur_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:295",
        "launches": large_chain["counts"]["K4"],
        "max_abs_err": max(k4_err, large_chain["chain_err"]),
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound"][0],
        "bound_by": k4["bound"][1],
        "library_ms": no_library,
    }, {
        "name": "tiled_stage_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/tiled_stage_planar.cu",
        "replaces": "hipe_tpu/ops/pallas_blur.py:319",
        "launches": large_chain["counts"]["K5"],
        "max_abs_err": max(k5_err, large_chain["chain_err"]),
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound"][0],
        "bound_by": k5["bound"][1],
        "library_ms": no_library,
        # The stages with a one-call counterpart, over the same 100 frames.
        "stage_ms": {nm: large_chain["yard"][f"K5 {nm}"] for nm in ("invert", "posterize4")},
        "stage_library_ms": {"invert": large_chain["yard"]["bitwise_not"],
                             "posterize4": large_chain["yard"]["bitwise_and"]},
        "copy_ms": large_chain["yard"]["copy_"],
    }, {
        "name": "dequant_idct_s16",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/dct_blocks.cu",
        "replaces": "hipe_tpu/ops/pallas_dct.py:72",
        "launches": (transcode["counts"]["K6"] + serving["launches"]["K6"]
                     + stats["launches"]["K6"]),
        "launches_per_pass": transcode["per_pass"]["K6"],
        # Phase 20: scaled-size-8, gray, full-size and CMYK/YCCK components.
        "serving_options_launches": serving["launches"]["K6"],
        # Phase 21: the serving paths with a global-statistics pipeline.
        "global_stats_launches": stats["launches"]["K6"],
        "max_abs_err": max(k6_err, codec_err),
        "ms": codec["split"]["K6"],
        "plain_ms": codec["plain_k6"],
        "bound_ms": codec["bounds"]["K6"][0],
        "bound_by": codec["bounds"]["K6"][1],
        "library_ms": no_library,
        # registers, spill stores, spill loads, stack frame, barriers, shared bytes
        "ptxas": dct_ptxas["dequant_idct_kernel"],
    }, {
        "name": "fdct_quantize_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/dct_blocks.cu",
        "replaces": "hipe_tpu/ops/pallas_dct.py:155",
        "launches": (transcode["counts"]["K7"] + serving["launches"]["K7"]
                     + stats["launches"]["K7"]),
        "launches_per_pass": transcode["per_pass"]["K7"],
        # Phase 20: the encode of every option's transcode.
        "serving_options_launches": serving["launches"]["K7"],
        # Phase 21: the transcodes with a global-statistics pipeline.
        "global_stats_launches": stats["launches"]["K7"],
        "max_abs_err": max(k7_err, codec_err),
        "ms": codec["split"]["K7"],
        "plain_ms": codec["plain_k7"],
        "bound_ms": codec["bounds"]["K7"][0],
        "bound_by": codec["bounds"]["K7"][1],
        "library_ms": no_library,
        "ptxas": dct_ptxas["fdct_quantize_kernel"],
    }, {
        "name": "ycc_rows_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/ycc_rows.cu",
        # hipe_tpu upsamples and converts colour in XLA ops: no pallas_call.
        "replaces": None,
        "launches": (transcode["counts"]["K11"] + serving["launches"]["K11"]
                     + stats["launches"]["K11"]),
        "launches_per_pass": transcode["per_pass"]["K11"],
        # Phase 20: the options whose decode it takes (scaled 4:2:0, full size).
        "serving_options_launches": serving["launches"]["K11"],
        "global_stats_launches": stats["launches"]["K11"],
        "max_abs_err": max(max(c["err"] for c in codec["k11"].values()), codec_err),
        # Alone over grids of the codec cell's shapes, beside a copy_ moving
        # as many bytes; then on phase 18's 256x256 stream.
        "ms": codec["k11"]["the cell"]["ms"],
        "plain_ms": codec["k11"]["the cell"]["plain_ms"],
        "bound_ms": codec["k11"]["the cell"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": no_library,
        "copy_ms": codec["k11"]["the cell"]["copy_ms"],
        # The any form, alone over the cases that take it.
        "any_form": {label: {k: c[k] for k in ("ms", "bound_ms", "copy_ms", "plain_ms")}
                     for label, c in codec["k11"].items() if c["form"] == "any"},
        "stream_ms": codec["split"]["K11"],
        "stream_plain_ms": codec["plain_k11"],
        "ptxas": {k: v for k, v in dct_ptxas.items() if k.startswith("ycc_rows")},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/equalize_planar.cu",
        # hipe_tpu's equalize is XLA ops: no pallas_call to replace.
        "replaces": None,
        "stage": stage,
        "launches": stats["kernels"][k]["launches"],
        # Phase 21: the equalize stream's launches, and those over its passes.
        "stream_launches": stats["kernels"][k]["stream_launches"],
        "launches_per_pass": stats["kernels"][k]["launches_per_pass"],
        "max_abs_err": max(stats["kernels"][k]["err"], stats["paths"]["equalize"]["err"]),
        "ms": stats["kernels"][k]["ms"],
        "plain_ms": stats["kernels"][k]["plain_ms"],
        "bound_ms": stats["kernels"][k]["bound_ms"],
        "bound_by": stats["kernels"][k]["bound_by"],
        "library_ms": no_library,
        # The same alone over the benchmark's 15000x240x320 stream.
        "bench_stream": stats["kernels"][k]["bench_stream"],
    } for k, name, stage in (("K8", "equalize_histogram_u8", "histogram"),
                             ("K9", "equalize_lut_u8", "table"),
                             ("K10", "equalize_apply_u8", "apply"))] + [{
        "name": "mode_planar_u8",
        "route": "cuda",
        "source": "hipe_tpu_torch/csrc/mode_planar.cu",
        # hipe_tpu's mode filter is XLA ops: no pallas_call to replace.
        "replaces": None,
        "launches": sum(stats["k12"][nm]["stream_launches"] for nm in ("mode", "mode5")),
        "max_abs_err": max(stats["k12"]["mode"]["err"], stats["k12"]["mode5"]["err"],
                           stats["paths"]["mode"]["err"], stats["paths"]["mode5"]["err"]),
        # Phase 21: alone over the benchmark's 15000x240x320 stream, at each
        # size, with its launches a pass of the 5000-image stream.
        "sizes": {nm: stats["k12"][nm] for nm in ("mode", "mode5")},
        "ms": stats["k12"]["mode5"]["ms"],
        "plain_ms": stats["k12"]["mode5"]["plain_ms"],
        "bound_ms": stats["k12"]["mode5"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": no_library,
        "ptxas": stats["k12"]["ptxas"],
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
