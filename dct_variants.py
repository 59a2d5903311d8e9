#!/usr/bin/env python3
"""Time design variants of kernel K7 (``hipe_tpu_torch/csrc/dct_blocks.cu``)
on one NVIDIA GPU, in turns, each held against the plain version.

    python3 dct_variants.py [OTHER_DCT_BLOCKS_CU]

Each variant is this checkout's ``dct_blocks.cu`` with one textual change,
compiled alone by ``nvcc`` into ``build/dct_variants/v<i>.so`` (seconds,
all at once), beside another commit's file if one is given ("other"):

- ``as built``: the source as it is (6 thread blocks an SM: 80 registers);
- ``4 CTAs``: ``__launch_bounds__`` with no minimum (the compiler's choice);
- ``5 CTAs``, ``7 CTAs``: other minimums (7 spills);
- ``64 threads``, ``256 threads``: other thread-block sizes, the same
  occupancy;
- ``lane stores``: each lane stores its own block's eight 16-byte rows
  (32 blocks 128 bytes apart an instruction) instead of the warp's staged
  whole-block stores.

For each: the ptxas report, SASS instructions a sample (``cuobjdump -sass``:
static instructions times the threads a launch runs, from torch.profiler's
grid and block, over its samples; K7 does not loop), its worst error against
``fdct_quantize_plain`` on grids of random, flat 0/255 and extreme blocks
(``chip_smoke.extreme_blocks``) under tables of 1, of 65535, quality 1/90
and random 16-bit tables, and its ms a pass (three launches: 5000x256x256
and 2x 5000x128x128 random grids, the codec stream's shapes, quality-90
tables), in three turns (the variants in order, reversed, in order). Prints
one JSON line and writes it to ``build/dct_variants/variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SOURCE = os.path.join(HERE, "hipe_tpu_torch", "csrc", "dct_blocks.cu")
OUT = os.path.join(HERE, "build", "dct_variants")
KERNEL = "fdct_quantize_kernel"
BOUNDS = "__launch_bounds__(kK7Threads, kK7MinCtas)"
STAGED_STORE = """    const int blk = live ? band * wb + bx : -1;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int from = 4 * s + (lane >> 3);
      const int k = __shfl_sync(0xffffffffu, blk, from);
      if (k >= 0) {
        *reinterpret_cast<uint4*>(coefs + static_cast<size_t>(k) * 64 + (lane & 7) * 8) =
            warp[from][lane & 7];
      }
    }
    __syncwarp();"""
LANE_STORE = """    if (live) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        *reinterpret_cast<uint4*>(coefs + (static_cast<size_t>(band) * wb + bx) * 64 + u * 8) =
            warp[lane][u];
      }
    }"""
VARIANTS = {
    "as built": [],
    "4 CTAs": [(BOUNDS, "__launch_bounds__(kK7Threads)")],
    "5 CTAs": [("kK7MinCtas = 6;", "kK7MinCtas = 5;")],
    "7 CTAs": [("kK7MinCtas = 6;", "kK7MinCtas = 7;")],
    "64 threads": [("kK7Threads = 128;", "kK7Threads = 64;"),
                   ("kK7MinCtas = 6;", "kK7MinCtas = 12;")],
    "256 threads": [("kK7Threads = 128;", "kK7Threads = 256;"),
                    ("kK7MinCtas = 6;", "kK7MinCtas = 3;")],
    "lane stores": [(STAGED_STORE, LANE_STORE)],
}


def build(sources: dict) -> dict:
    """name -> (ctypes library, ptxas numbers of K7, static SASS instructions)."""
    from chain_ab import ptxas_report, sass_instructions
    from hipe_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = os.path.join(OUT, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", src[:-3] + ".so", src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), src[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(so)
        lib.hipe_fdct_quantize_u8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        libs[name] = (lib, ptxas_report(log, KERNEL), sass_instructions(so, KERNEL))
    return libs


def launch(lib, grid, table, out) -> None:
    import numpy as np
    import torch

    q = np.ascontiguousarray(np.asarray(table).astype(np.uint32))
    b, h, w = grid.shape
    rc = lib.hipe_fdct_quantize_u8(grid.data_ptr(), out.data_ptr(), q.ctypes.data, b, h // 8,
                                   w // 8, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"K7 variant launch failed: cudaError {rc}")


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from chain_ab import launch_threads
    from hipe_tpu_torch.io_.jpeg import quality_tables
    from hipe_tpu_torch.ops import jpeg_encode as je

    card = cs.phase_env()
    with open(SOURCE) as f:
        text = f.read()
    sources = {}
    if len(sys.argv) > 1:
        with open(sys.argv[1]) as f:
            sources["other"] = f.read()
    for name, subs in VARIANTS.items():
        t = text
        for old, new in subs:
            if t.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old!r} is not in {SOURCE} once")
            t = t.replace(old, new)
        sources[name] = t
    libs = build(sources)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    tables = {"all 1": np.ones(64), "all 65535": np.full(64, 65535),
              "q1 luma": quality_tables(1)[0], "q90 chroma": quality_tables(90)[1],
              "random 16-bit": np.random.default_rng(0).integers(1, 65536, 64)}
    inputs = [cs.random_grid((1 + (hb + wb) % 8, hb, wb), kind, gen)
              for hb, wb in cs.DCT_GRIDS for kind in cs.random_grid.kinds]
    shapes = ((cs.SIDE, quality_tables(90)[0]),) + ((cs.SIDE // 2, quality_tables(90)[1]),) * 2
    grids = [torch.randint(0, 256, (cs.NUM_IMAGES, s, s), dtype=torch.uint8, device=dev,
                           generator=gen) for s, _ in shapes]
    outs = [torch.empty((cs.NUM_IMAGES, s // 8, s // 8, 64), dtype=torch.int16, device=dev)
            for s, _ in shapes]
    samples = sum(g.numel() for g in grids)

    def one_pass(lib):
        for g, (_, q), o in zip(grids, shapes, outs):
            launch(lib, g, q, o)

    res = {}
    for name, (lib, ptxas, sass) in libs.items():
        err = 0
        for x in inputs:
            for q in tables.values():
                o = torch.empty((x.shape[0], x.shape[1] // 8, x.shape[2] // 8, 64),
                                dtype=torch.int16, device=dev)
                launch(lib, x, q, o)
                err = max(err, cs.max_abs_err(o, je.fdct_quantize_plain(x, q)))
        threads = launch_threads(lambda: one_pass(lib))["K7"]
        res[name] = {"ptxas": ptxas, "sass_instructions": sass,
                     "sass_a_sample": sass * threads / samples if threads else None,
                     "max_abs_err": err, "ms": []}
    for name in [*libs, *reversed(libs), *libs]:
        res[name]["ms"].append(cs.cuda_ms(lambda: one_pass(libs[name][0]), reps=20))
    want = [cs.chunked(je.fdct_quantize_plain, g, q) for g, (_, q) in zip(grids, shapes)]
    for name, (lib, _, _) in libs.items():
        for o in outs:
            o.fill_(-1)
        one_pass(lib)
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], *(
            cs.max_abs_err(o, w) for o, w in zip(outs, want)))
    line = json.dumps({"card": card, "variants": res})
    with open(os.path.join(OUT, "variants.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    bad = {name: r["max_abs_err"] for name, r in res.items() if r["max_abs_err"]}
    if bad:
        raise SystemExit(f"variants differ from the plain version: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
