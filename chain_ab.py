#!/usr/bin/env python3
"""Time the port's kernels of this checkout against another checkout's, in
turns, on one NVIDIA GPU.

    git archive <commit> chip_smoke.py hipe_tpu_torch | tar -x -C build/other
    python3 chain_ab.py build/other
    python3 chain_ab.py --stages build/other
    python3 chain_ab.py --tiled build/other
    python3 chain_ab.py --blur build/other
    python3 chain_ab.py --dct build/other
    python3 chain_ab.py --engine build/other
    python3 chain_ab.py --k2 build/other

Runs four processes one after another, each on one tree: OTHER, THIS,
THIS, OTHER. Each builds its tree's kernels (into that tree's ``build/``).
By default each runs that tree's ``chip_smoke.py`` phases 7 and 8 (the
chain and denoise main paths over the 5000-image stream: autotune, verify,
three sessions, 3 chained passes against the plain version), and the first
run of each tree also times every program of :data:`CHAINS` over the same
stream, once each at every ``rows_per_block`` its tree takes, keeping the
fastest. With ``--stages`` each instead times the short programs of
:data:`STAGES` (what a stage adds to a pass) over a random 5000-image stream
at 8, 32, 64 and 128 rows a block. With ``--tiled`` each runs its tree's
``chip_smoke.py`` phase 14 (the chain and blur3 over 100 frames of
4000x2250 on K4/K5, with K4's and K5's own times), and times K1, K2 and K3
on the 5000-image stream and K6 and K7 on its coefficient grids at fixed
knobs (kernels the tiled work leaves alone: they must not move); the
first run of each tree also times every stage of ``chip_smoke.K5_STAGES``
over the 100 frames at every tile its autotune sweeps, at full-width
strips and at tiles of 128 rows or 1024 columns, keeping the fastest.
With ``--blur`` each runs its tree's ``chip_smoke.py`` phases 6 (blur3
over the 5000-image planar stream, K1), 13 (blur3 over the rows stream,
K1's rows entry), 14 for blur3 (the 100 frames of 4000x2250 on the tree's
route) and 18 (the codec's paths, the transcode among them) and K1 alone
over the benchmark's 15000x240x320 stream (phase 6's ``K1 bench
stream``), times K1's rows entry at C = 3 over 5000 images of 320x240 at
every ``rows_per_block`` the autotune sweeps beside a ``Tensor.copy_``
(``chip_smoke.sweep_rows_per_block``; the other tree's ``chip_smoke.py``
needs both), and times at fixed knobs: K1 for gaussian5/7/9 over the
5000-image stream, K1's rows entry at C = 1 and 4 over the rows stream,
blur3 through
``Pipeline.apply_rows`` over 100 RGB frames of 4000x2250 (a relayout to
planar and back on the tiled route, or K1's rows entry), K4 over the
5000-image stream at every tile its autotune sweeps, and K1, K2, K3, K6 and
K7 as ``--tiled`` does. With ``--dct`` each runs its tree's
``chip_smoke.py`` phase 18 (the codec's encode, decode, decode + blur3 and
transcode over the 5000-image 4:2:0 q90 stream, each against the plain path)
and times K6 alone (the stream's three coefficient sets) and K7 alone (the
three sample grids K6 makes of them), each against its plain version, and
reads K6's and K7's ptxas report from the tree's build log and their SASS
(``cuobjdump -sass`` of the tree's library): static instructions, and
instructions a sample, which is that times the threads a launch runs
(grid and block from a torch.profiler trace) over its samples, as neither
kernel loops. With ``--engine`` each runs its tree's ``chip_smoke.py``
phase 19 (the heterogeneous engine's runs over the 5000-image 320x240
stream: approach 1 and 2, the calibrations, the fleet, and the 115 MB
transfers). With ``--k2`` each runs its tree's ``chip_smoke.py`` phases 7
and 8 and times K2's chain and K3's denoise at every ``rows_per_block``
the autotune sweeps and at the whole plane, over a random 5000-image
256x256 RGB planar stream and over the benchmark's 15000 planes of
240x320. Prints one JSON line a run and writes them to
``build/chain_ab/chain_ab.jsonl`` (``chain_ab_stages.jsonl``,
``chain_ab_tiled.jsonl``, ``chain_ab_blur.jsonl``, ``chain_ab_dct.jsonl``,
``chain_ab_engine.jsonl``, ``chain_ab_k2.jsonl``); exits non-zero if a
run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# K2's and K3's programs, as chip_smoke.py held them before the redesign
# (its K2_CHAINS and K3_CHAINS less the two main paths): the same programs
# on both trees. "dim", "q" and "tilt" are registered as chip_smoke.py does.
CHAINS = (
    ("sharpen",), ("edge",), ("invert",), ("sharpen", "invert"), ("gaussian5", "solarize"),
    ("posterize4", "gaussian9", "edge"), ("gaussian7",), ("dim", "gaussian3"),
    ("posterize1", "edge"),
    ("erode", "dilate"), ("dilate", "erode"), ("median",), ("median5", "edge"),
    ("erode5", "dilate5"), ("median7",), ("posterize4", "median9"),
    ("pil_emboss", "gaussian3"), ("pil_find_edges", "pil_contour", "pil_smooth_more"),
    ("q", "edge"), ("dim", "tilt", "median"),
)
# One point stage alone, one to four of them (the cost of a stage that
# writes shared memory), each main-path stage before a point stage, and
# the two main paths.
STAGES = (
    ("invert",), ("invert",) * 2, ("invert",) * 4, ("gaussian3", "invert"),
    ("sharpen", "invert"), ("edge", "invert"), ("median", "invert"),
    ("gaussian3", "sharpen", "edge"), ("median", "gaussian3"),
)
STAGE_ROWS_PER_BLOCK = (8, 32, 64, 128)


def chain_kernel(names):
    """K2's wrapper for a band chain (a single gaussian too), else K3's."""
    from hipe_tpu_torch.ops.chain_program import is_band_chain
    from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
    from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda

    return filter_chain_planar_cuda if is_band_chain(names) else rank_chain_planar_cuda


def stages(cs) -> dict:
    """ms a pass of each program of STAGES at each of STAGE_ROWS_PER_BLOCK."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (cs.NUM_IMAGES * cs.CHANNELS, cs.SIDE, cs.SIDE),
                      dtype=torch.uint8, device="cuda", generator=gen)
    out = torch.empty_like(x)
    return {f"{'+'.join(names)}@{rpb}": cs.cuda_ms(lambda: chain_kernel(names)(
                x, names, rows_per_block=rpb, out=out), reps=5)
            for names in STAGES for rpb in STAGE_ROWS_PER_BLOCK}


def fixed_knobs(cs) -> dict:
    """ms a pass of K1 (blur3), K2 (chain) and K3 (denoise) over a random
    5000-image planar stream at 32, 64 and 128 rows a block, and of K6 and
    K7 over the 5000-image 4:2:0 luma and chroma grids with the quality-90
    tables."""
    import torch

    from hipe_tpu_torch.io_.jpeg import quality_tables
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda
    from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
    from hipe_tpu_torch.ops.cuda_dct import dequant_idct_cuda, fdct_quantize_cuda
    from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (cs.NUM_IMAGES * cs.CHANNELS, cs.SIDE, cs.SIDE),
                      dtype=torch.uint8, device="cuda", generator=gen)
    out = torch.empty_like(x)
    res = {
        "K1 blur3@32": cs.cuda_ms(lambda: gaussian_blur_planar_cuda(
            x, 1, rows_per_block=32, out=out), reps=cs.PASSES),
        "K2 chain@64": cs.cuda_ms(lambda: filter_chain_planar_cuda(
            x, ("gaussian3", "sharpen", "edge"), rows_per_block=64, out=out), reps=cs.PASSES),
        "K3 denoise@128": cs.cuda_ms(lambda: rank_chain_planar_cuda(
            x, ("median", "gaussian3"), rows_per_block=128, out=out), reps=cs.PASSES),
    }
    del x, out
    tables = quality_tables(90)
    blocks = [(cs.SIDE // 8, cs.SIDE // 8, tables[0])] + [(cs.SIDE // 16, cs.SIDE // 16,
                                                          tables[1])] * 2
    coefs = [torch.randint(-2048, 2048, (cs.NUM_IMAGES, hb, wb, 64), dtype=torch.int32,
                           device="cuda", generator=gen).to(torch.int16)
             for hb, wb, _ in blocks]
    grids = [dequant_idct_cuda(c, q) for c, (_, _, q) in zip(coefs, blocks)]
    outs = [torch.empty_like(c) for c in coefs]
    res["K6"] = cs.cuda_ms(lambda: [dequant_idct_cuda(c, q, out=g) for c, (_, _, q), g
                                    in zip(coefs, blocks, grids)], reps=cs.PASSES)
    res["K7"] = cs.cuda_ms(lambda: [fdct_quantize_cuda(g, q, out=o) for g, (_, _, q), o
                                    in zip(grids, blocks, outs)], reps=cs.PASSES)
    del coefs, grids, outs
    torch.cuda.empty_cache()
    return res


def tiled(cs, card: str, sweep: bool) -> dict:
    """Phase 14 of the tree's chip_smoke.py, the fixed-knob kernels and, with
    ``sweep``, each K5 stage over the 100 frames at its best tile."""
    import torch

    from hipe_tpu_torch.ops import blur as tblur
    from hipe_tpu_torch.ops.cuda_tiled import filter_stage_planar_tiled_cuda
    from hipe_tpu_torch.ops.planar import TILE_COLS_CANDIDATES, TILE_ROWS_CANDIDATES
    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu_torch.utils.images import checker_image

    res = {}
    for name in ("chain", "blur3"):
        r = cs.phase_large_frames(card, name)
        res[f"large {name}"] = {"ms": r["ms"], "own": {
            k: {"ms": v["ms"], "best_ms": v["best"][0], "best_tile": v["best"][1]}
            for k, v in r["own"].items()}}
    res["fixed knobs"] = fixed_knobs(cs)
    if sweep:
        tblur.register_lut_filter(cs.LUT_NAME, tblur.brightness_lut(0.7))
        tblur.register_rank_filter(cs.RANK_NAME, 5, 6)
        tblur.register_kernel_filter(cs.KERNEL_NAME, range(-12, 13), 7, 2.5)
        image = checker_image(cs.LARGE_H, cs.LARGE_W, cs.CHANNELS, seed=0)
        runner = DeviceStreamRunner("blur3", num_images=cs.LARGE_FRAMES, image=image,
                                    device="cuda")
        x, out = runner.stream, runner._bufs[0]
        tiles = [*((th, tw) for th in TILE_ROWS_CANDIDATES for tw in TILE_COLS_CANDIDATES),
                 *((th, cs.LARGE_W) for th in (8, 16, 32, 48)),
                 (128, 256), (128, 512), (64, 1024), (128, 1024)]
        res["K5 stages"] = {}
        for name in cs.K5_STAGES:
            times = {}
            for tile in dict.fromkeys(tiles):
                try:
                    times[tile] = cs.cuda_ms(lambda: filter_stage_planar_tiled_cuda(
                        x, name, tile=tile, out=out), reps=3)
                except RuntimeError:
                    continue  # a tile beyond shared memory: refused
            best = min(times, key=times.get)
            res["K5 stages"][name] = {"ms": times[best], "tile": best, "all": {
                f"{t[0]}x{t[1]}": round(v, 4) for t, v in times.items()}}
        del runner, x, out
        torch.cuda.empty_cache()
    return res


def blur(cs, card: str) -> dict:
    """The blur paths of the tree's chip_smoke.py (phases 6, 13, 14 for
    blur3, 18), K1 alone over the benchmark's stream, K1's rows entry over
    320x240 RGB at every rows_per_block, and K1, K4 and the other kernels at
    fixed knobs."""
    import torch

    from hipe_tpu_torch.models.pipelines import get
    from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda, gaussian_blur_rows_cuda
    from hipe_tpu_torch.ops.cuda_tiled import gaussian_blur_planar_tiled_cuda
    from hipe_tpu_torch.ops.planar import TILE_COLS_CANDIDATES, TILE_ROWS_CANDIDATES

    res = {}
    r = cs.phase_main_path(card, "6", "blur3")
    res["blur3"] = {"ms": r["ms"], "idle": r["idle"], "copy_ms": r.get("copy_ms")}
    res["rows blur3"] = cs.phase_rows_main_path(card)["ms"]
    r = cs.phase_large_frames(card, "blur3")
    res["large blur3"] = {"ms": r["ms"], "own": {
        k: {"ms": v["ms"], "best_ms": v["best"][0], "best_at": v["best"][1]}
        for k, v in r["own"].items()}}
    codec = cs.phase_codec_main_paths(card)
    res["codec"] = {name: p["ms"] for name, p in codec["paths"].items()}
    res["codec K1 rows"] = codec["split"]["K1 rows"]
    res["K1 bench stream"] = cs.phase_k1_bench_stream(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (cs.NUM_IMAGES, 240, 320 * 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    out = torch.empty_like(x)
    res["K1 rows 320x240x3"] = cs.sweep_rows_per_block(
        lambda rpb: gaussian_blur_rows_cuda(x, 3, 1, rows_per_block=rpb, out=out), x, out)
    x = torch.randint(0, 256, (cs.NUM_IMAGES * cs.CHANNELS, cs.SIDE, cs.SIDE),
                      dtype=torch.uint8, device="cuda", generator=gen)
    out = torch.empty_like(x)
    fixed = {}
    for radius in (2, 3, 4):
        for rpb in (32, 128):
            fixed[f"K1 gaussian{2 * radius + 1}@{rpb}"] = cs.cuda_ms(
                lambda: gaussian_blur_planar_cuda(x, radius, rows_per_block=rpb, out=out),
                reps=cs.PASSES)
    rows, rows_out = x.view(cs.NUM_IMAGES, cs.SIDE, -1), out.view(cs.NUM_IMAGES, cs.SIDE, -1)
    for c in (1, 3, 4):
        fixed[f"K1 rows C{c}@32"] = cs.cuda_ms(lambda: gaussian_blur_rows_cuda(
            rows, c, 1, rows_per_block=32, out=rows_out), reps=cs.PASSES)
    k4 = {f"{th}x{tw}": cs.cuda_ms(lambda: gaussian_blur_planar_tiled_cuda(
        x, 1, tile=(th, tw), out=out), reps=cs.PASSES)
        for th in TILE_ROWS_CANDIDATES for tw in TILE_COLS_CANDIDATES}
    best = min(k4, key=k4.get)
    fixed["K4 blur3 best"] = {"ms": k4[best], "tile": best}
    del x, out, rows, rows_out
    torch.cuda.empty_cache()
    frames = torch.randint(0, 256, (cs.LARGE_FRAMES, cs.LARGE_H, cs.LARGE_W * cs.CHANNELS),
                           dtype=torch.uint8, device="cuda", generator=gen)
    frames_out = torch.empty_like(frames)
    pipe = get("blur3")
    fixed["large rows blur3 apply_rows"] = cs.cuda_ms(
        lambda: pipe.apply_rows(frames, cs.CHANNELS, out=frames_out), reps=3)
    del frames, frames_out
    torch.cuda.empty_cache()
    res["fixed"] = fixed
    res["fixed knobs"] = fixed_knobs(cs)
    return res


def k2_rows(cs) -> dict:
    """ms a pass of K2's chain and K3's denoise at every rows_per_block the
    autotune sweeps, over the 256x256 stream and the benchmark's 240x320
    planes, with the fastest of each."""
    import torch

    from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
    from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
    from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

    res = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for side, shape in (("256x256", (cs.NUM_IMAGES * cs.CHANNELS, cs.SIDE, cs.SIDE)),
                        ("240x320", (15000, 240, 320))):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
        out = torch.empty_like(x)
        for label, fn, names in (("K2 chain", filter_chain_planar_cuda,
                                  ("gaussian3", "sharpen", "edge")),
                                 ("K3 denoise", rank_chain_planar_cuda, ("median", "gaussian3"))):
            times = {rpb: cs.cuda_ms(lambda: fn(x, names, rows_per_block=rpb, out=out),
                                     reps=cs.PASSES)
                     for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, shape[1]})}
            best = min(times, key=times.get)
            res[f"{label} {side}"] = {"ms": times[best], "rows_per_block": best,
                                      "all": {k: round(v, 4) for k, v in times.items()}}
        del x, out
        torch.cuda.empty_cache()
    return res


DCT_KERNELS = {"K6": "dequant_idct_kernel", "K7": "fdct_quantize_kernel"}


def ptxas_report(log: str, name: str) -> list:
    """The ptxas numbers of kernel ``name`` in an ``nvcc -Xptxas -v`` log:
    registers, spill stores, spill loads, stack frame, barriers, shared
    bytes; -1 where the report lacks one."""
    import re

    entry = next(e for e in log.split("Compiling entry function")[1:]
                 if name in e.split("\n")[0])
    found = [re.search(pat, entry) for pat in (
        r"Used (\d+) registers", r"(\d+) bytes spill stores", r"(\d+) bytes spill loads",
        r"(\d+) bytes stack frame", r"used (\d+) barriers", r"(\d+) bytes smem")]
    return [int(m.group(1)) if m else -1 for m in found]


def sass_instructions(lib: str, name: str) -> int:
    """Static SASS instructions of kernel ``name`` in the library ``lib``
    (``cuobjdump -sass``, beside ``nvcc``)."""
    import re

    from hipe_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    fn = next(f for f in sass.split("Function : ")[1:] if name in f.split("\n")[0])
    return len(re.findall(r"/\*[0-9a-f]{4}\*/\s+\S", fn))


def launch_threads(fn, per_call: int = 3) -> dict:
    """Threads one ``fn()`` runs in each DCT kernel, by kernel label: the
    grids and blocks torch.profiler records for the last ``per_call``
    launches of each over three calls (a trace can miss its first ones)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out_dir = os.path.join(HERE, "build", "chain_ab")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".json", dir=out_dir) as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as trace:
            events = json.load(trace)["traceEvents"]
    launches = {label: [] for label in DCT_KERNELS}
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        args = e.get("args", {})
        for label, name in DCT_KERNELS.items():
            if e.get("cat") == "kernel" and name in e.get("name", "") and "grid" in args:
                g, b = args["grid"], args["block"]
                launches[label].append(g[0] * g[1] * g[2] * b[0] * b[1] * b[2])
    return {label: sum(t[-per_call:]) if len(t) >= per_call else 0
            for label, t in launches.items()}


def dct(cs, card: str) -> dict:
    """Phase 18 of the tree's chip_smoke.py, and K6 and K7 alone over the
    phase-18 stream: ms, max_abs_err against the plain versions, ptxas
    numbers and SASS instructions."""
    import torch

    from hipe_tpu_torch.io_.jpeg import quality_tables
    from hipe_tpu_torch.ops import _build, cuda_dct
    from hipe_tpu_torch.ops import jpeg_decode as jd
    from hipe_tpu_torch.ops import jpeg_encode as je
    from hipe_tpu_torch.utils.images import checker_image

    codec = cs.phase_codec_main_paths(card)
    res = {"codec": {name: {"ms": p["ms"], "err": p["err"]}
                     for name, p in codec["paths"].items()},
           "split": codec["split"]}
    # The phase-18 stream, as chip_smoke.py makes it.
    geo = je.encode_geometry(cs.SIDE, cs.SIDE, cs.CHANNELS, "420")
    luma, chroma = quality_tables(90)
    qt = [luma, chroma, chroma]
    one = torch.from_numpy(checker_image(cs.SIDE, cs.SIDE, cs.CHANNELS, seed=0)).cuda()[None]
    coefs = [c.expand(cs.NUM_IMAGES, *c.shape[1:]).contiguous()
             for c in je.encode_planes(geo, one, qt)]
    grids = [cuda_dct.dequant_idct_cuda(c, q) for c, q in zip(coefs, qt)]
    outs = [cuda_dct.fdct_quantize_cuda(g, q) for g, q in zip(grids, qt)]
    res["K6"] = {"ms": cs.cuda_ms(lambda: [cuda_dct.dequant_idct_cuda(c, q, out=g) for c, q, g
                                          in zip(coefs, qt, grids)], reps=cs.PASSES),
                 "err": max(cs.max_abs_err(g, cs.chunked(jd.idct8x8_islow, c, q))
                            for c, q, g in zip(coefs, qt, grids))}
    res["K7"] = {"ms": cs.cuda_ms(lambda: [cuda_dct.fdct_quantize_cuda(g, q, out=o) for g, q, o
                                          in zip(grids, qt, outs)], reps=cs.PASSES),
                 "err": max(cs.max_abs_err(o, cs.chunked(je.fdct_quantize_plain, g, q))
                            for g, q, o in zip(grids, qt, outs))}
    threads = launch_threads(lambda: ([cuda_dct.dequant_idct_cuda(c, q, out=g) for c, q, g
                                       in zip(coefs, qt, grids)],
                                      [cuda_dct.fdct_quantize_cuda(g, q, out=o) for g, q, o
                                       in zip(grids, qt, outs)]))
    samples = sum(g.numel() for g in grids)
    lib = _build.build()
    log = (lib.parent / "build.log").read_text()
    for label, name in DCT_KERNELS.items():
        sass = sass_instructions(str(lib), name)
        res[label].update(ptxas=ptxas_report(log, name), sass_instructions=sass,
                          sass_a_sample=sass * threads[label] / samples if threads[label] else None)
    if res["K6"]["err"] or res["K7"]["err"]:
        raise AssertionError(f"K6/K7 differ from their plain versions: {res}")
    print(f"[dct] K6 {res['K6']} K7 {res['K7']} [{card}]", flush=True)
    del coefs, grids, outs
    torch.cuda.empty_cache()
    return res


def one(root: str, mode: str) -> dict:
    """One tree's run, in this process: ``root``'s own package and script;
    ``mode`` is "sweep" (the main paths and CHAINS), "paths", "stages",
    "tiled-sweep" (phase 14 and the K5 stages), "tiled", "blur", "dct",
    "engine" or "k2" (the main paths and K2's and K3's rows a block)."""
    root = os.path.abspath(root)
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from hipe_tpu_torch.ops import blur as tblur
    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

    card = cs.phase_env()
    cs.phase_build(card)
    res = {"root": root, "card": card}
    if mode == "stages":
        res["stages"] = stages(cs)
        return res
    if mode.startswith("tiled"):
        res.update(tiled(cs, card, mode == "tiled-sweep"))
        return res
    if mode == "blur":
        res.update(blur(cs, card))
        return res
    if mode == "dct":
        res.update(dct(cs, card))
        return res
    if mode == "engine":
        res.update(cs.phase_engine(card))
        return res
    for phase, name in (("7", "chain"), ("8", "denoise")):
        res[name] = cs.phase_main_path(card, phase, name)["ms"]
    if mode == "k2":
        res.update(k2_rows(cs))
    if mode == "sweep":
        tblur.register_lut_filter("dim", tblur.brightness_lut(0.7))
        tblur.register_rank_filter("q", 5, 6)
        tblur.register_kernel_filter("tilt", range(-12, 13), 7, 2.5)
        runner = DeviceStreamRunner("blur3", num_images=cs.NUM_IMAGES, device="cuda")
        x, out = runner.stream, runner._bufs[0]
        res["sweep"] = {}
        for names in CHAINS:
            times = {}
            for rpb in (c["rows_per_block"] for _, c, _ in runner.candidates):
                try:
                    times[rpb] = cs.cuda_ms(lambda: chain_kernel(names)(
                        x, names, rows_per_block=rpb, out=out), reps=3)
                except RuntimeError:
                    continue  # a tile beyond shared memory: refused
            best = min(times, key=times.get)
            res["sweep"]["+".join(names)] = {"ms": times[best], "rows_per_block": best}
        del runner, x, out
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print("RESULT " + json.dumps(one(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    known = {"--stages", "--tiled", "--blur", "--dct", "--engine", "--k2"}
    if len(args) != 1 or len(flags) > 1 or not set(flags) <= known:
        raise SystemExit(__doc__)
    other = os.path.abspath(args[0])
    if not os.path.exists(os.path.join(other, "chip_smoke.py")):
        raise SystemExit(f"{other} holds no chip_smoke.py")
    out_dir = os.path.join(HERE, "build", "chain_ab")
    os.makedirs(out_dir, exist_ok=True)
    results, failed = [], False
    flag = flags[0] if flags else ""
    modes, name = {
        "--stages": (("stages",) * 4, "chain_ab_stages.jsonl"),
        "--tiled": (("tiled-sweep", "tiled-sweep", "tiled", "tiled"), "chain_ab_tiled.jsonl"),
        "--blur": (("blur",) * 4, "chain_ab_blur.jsonl"),
        "--dct": (("dct",) * 4, "chain_ab_dct.jsonl"),
        "--engine": (("engine",) * 4, "chain_ab_engine.jsonl"),
        "--k2": (("k2",) * 4, "chain_ab_k2.jsonl"),
    }.get(flag, (("sweep", "sweep", "paths", "paths"), "chain_ab.jsonl"))
    for root, mode in zip((other, HERE, HERE, other), modes):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, mode],
                              capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        for ln in lines:
            if not ln.startswith("RESULT "):
                print(ln, flush=True)
        found = [json.loads(ln[len("RESULT "):]) for ln in lines if ln.startswith("RESULT ")]
        if proc.returncode or not found:
            failed = True
            print(f"run on {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}", flush=True)
            continue
        found[0]["seconds"] = time.perf_counter() - t0
        results.append(found[0])
        print(json.dumps(found[0]), flush=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in results)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
