"""Command line of the PyTorch/CUDA port (counterpart of ``hipe_tpu.cli``).

``stream`` runs the device-resident stream on an NVIDIA GPU. It takes a
pipeline name, a bare stage name or a comma-joined chain of stages;
``--kernel``, ``--lut`` and ``--rank`` register stages with ``hipe_tpu``'s
grammar::

    python -m hipe_tpu_torch.cli stream blur3 --num-images 5000 --json
    python -m hipe_tpu_torch.cli stream chain --num-images 5000 --json
    python -m hipe_tpu_torch.cli stream denoise --num-images 5000 --json
    python -m hipe_tpu_torch.cli stream gaussian3,sharpen,edge --json
    python -m hipe_tpu_torch.cli stream dim,gaussian3 --lut dim=brightness:0.7
    python -m hipe_tpu_torch.cli stream q,edge --rank q=5:6
    python -m hipe_tpu_torch.cli stream soft,sharpen --kernel soft=1,2,1,2,4,2,1,2,1:16

The global-statistics pipelines (equalize, autocontrast, contrast, color,
sharpness, mode, mode5) take ``--factor`` (contrast/color/sharpness),
``--cutoff`` and ``--preserve-tone`` (autocontrast), here and on ``serve``,
``approach1`` and ``approach2``::

    python -m hipe_tpu_torch.cli stream equalize --json
    python -m hipe_tpu_torch.cli stream autocontrast --cutoff 2 --json
    python -m hipe_tpu_torch.cli stream contrast --factor 1.5 --json

The stream's image is ``checker_image(256, 256, 3, seed=0)``, or ``--image
PATH`` (a JPEG; needs libjpeg). Without a CUDA device the command fails: it
never runs on the CPU.

``serve`` runs JPEG decode -> filter -> encode over a stream of JPEGs, with
the same pipeline grammar, in one of four placements (host codec, device
decode, device encode, or both: the full transcode on the card)::

    python -m hipe_tpu_torch.cli serve blur3 --decode-on-device \
        --encode-on-device --num-images 500 --json

Its input is ``checker_image(256, 256, 3, seed=0)`` (or ``--image PATH``)
encoded by the port's host codec at ``--quality``. The host codec is
libjpeg, built at first use; where g++ or libjpeg is missing, ``serve``
fails and says so. ``--device cpu`` runs it on the CPU, with the kernels'
plain versions. ``hipe_tpu``'s serving options select the stages around the
filter::

    python -m hipe_tpu_torch.cli serve blur3 --decode-scale 4 --gray --json
    python -m hipe_tpu_torch.cli serve blur3 --decode-gray --resize 64 48 --json
    python -m hipe_tpu_torch.cli serve blur3 --thumbnail --encode-on-device --json
    python -m hipe_tpu_torch.cli serve blur3 --decode-gray \
        --colorize navy:#ffe0a0:maroon --json

``transform`` is the lossless DCT-domain transform of JPEG files (the
jpegtran analog; several inputs take the batched path and ``-o`` names a
directory)::

    python -m hipe_tpu_torch.cli transform IMG.jpg rot90 -o out.jpg
    python -m hipe_tpu_torch.cli transform IMG.jpg crop --crop 32 32 100 75 -o c.jpg

``approach1`` and ``approach2`` are the reference's two programs
(``heterogeneous_blur [cpu|gpu|both] [gpu_ratio] [batch_size]`` and
``split_image_blur [gpu_ratio] [batch_size]``) over a host-CPU lane (the
plain PyTorch chain) and a CUDA lane (the kernels), with the reference's
positional grammar, warn-and-default validation and 8-section report::

    python -m hipe_tpu_torch.cli approach1 gpu 1.0 500 --num-images 5000
    python -m hipe_tpu_torch.cli approach1 both 0.9 500 --scheduler greedy
    python -m hipe_tpu_torch.cli approach2 0.9 35 --pipeline chain

Their stream replicates ``checker_image(240, 320, 3, seed=0)``, the
reference's 320x240 geometry, or ``--image`` (JPEG paths, comma-separated
for a mixed-resolution stream; needs libjpeg). Modes ``both`` and ``gpu``
need a CUDA card and fail without one; ``tpu`` and ``accel`` are aliases
of ``gpu``.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys

IMAGE_NAME = "checker_image(256,256,3,seed=0)"
APPROACH_IMAGE_NAME = "checker_image(240,320,3,seed=0)"


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one line each."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return proc.stdout.strip() or proc.stderr.strip()


def _add_stage_flags(p: argparse.ArgumentParser) -> None:
    """The pipeline argument and the stage-registering flags."""
    p.add_argument("pipeline_name", nargs="?", default="blur3",
                   help="a pipeline, a stage name, or a comma-joined chain "
                        "of stages")
    _add_register_flags(p)


def _add_register_flags(p: argparse.ArgumentParser) -> None:
    """--kernel, --lut and --rank: register stages by hipe_tpu's grammar."""
    p.add_argument(
        "--kernel", action="append", metavar="NAME=TAPS[:SCALE[:OFFSET]]",
        help="register a custom convolution kernel as a chainable filter "
             "stage (taps comma-separated in PIL ImageFilter.Kernel order, "
             "odd square 3x3-9x9; scale defaults to sum(taps); offset in "
             "halves). Repeatable. Example: "
             "--kernel soft=1,2,1,2,4,2,1,2,1:16 soft,sharpen")
    p.add_argument(
        "--lut", action="append", metavar="NAME=SPEC",
        help="register a 256-entry LUT as a chainable radius-0 point stage. "
             "SPEC is brightness:F (PIL ImageEnhance.Brightness, bit-exact), "
             "gamma:G, solarize:T (PIL threshold), or 256 comma-separated "
             "uint8 values. Repeatable. Example: --lut dim=brightness:0.7 "
             "dim,gaussian3")
    p.add_argument(
        "--rank", action="append", metavar="NAME=SIZE:RANK",
        help="register PIL RankFilter(SIZE, RANK) as a chainable stage "
             "(SIZE odd 3..9, RANK in [0, SIZE^2); bit-exact incl. borders; "
             "median5/erode5/dilate5/median7/median9 are pre-registered). "
             "Repeatable. Example: --rank q=5:6 q,edge")


def _add_stats_flags(p: argparse.ArgumentParser) -> None:
    """--factor, --cutoff and --preserve-tone: the global-statistics settings."""
    p.add_argument("--factor", type=float, default=None,
                   help="contrast/color/sharpness only: PIL ImageEnhance strength "
                        "(bit-exact; 1.0 = identity, <1 reduces, >1 boosts)")
    p.add_argument("--cutoff", type=int, nargs="+", default=None, metavar="PCT",
                   help="autocontrast only: trim PCT percent (or two values: low high) "
                        "of histogram mass from each end before stretching (PIL "
                        "cutoff semantics, bit-exact)")
    p.add_argument("--preserve-tone", action="store_true",
                   help="autocontrast only: PIL preserve_tone, one luminance-derived "
                        "range applied to all channels (bit-exact)")


def build_parser() -> argparse.ArgumentParser:
    from hipe_tpu_torch.ops.jpeg_encode import DEVICE_SUBSAMPLINGS
    from hipe_tpu_torch.ops.jpeg_transform import ALL_OPS

    p = argparse.ArgumentParser(prog="hipe_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    st = sub.add_parser("stream", help="device-resident stream on the GPU")
    _add_stage_flags(st)
    st.add_argument("--num-images", type=int, default=5000)
    st.add_argument("--image", default=None, metavar="PATH",
                    help=f"input JPEG (default: {IMAGE_NAME}); needs libjpeg")
    st.add_argument("--passes", type=int, default=10)
    st.add_argument("--no-autotune", action="store_true",
                    help="skip the measured rows_per_block selection")
    st.add_argument("--retune", action="store_true",
                    help="ignore the stored autotune winner and sweep again")
    st.add_argument("--json", action="store_true",
                    help="print one JSON result line")
    st.add_argument("--device", default="cuda",
                    help="CUDA device to run on (default: cuda)")
    _add_stats_flags(st)
    sv = sub.add_parser("serve", help="JPEG decode -> filter -> encode over a "
                                      "stream of JPEGs")
    _add_stage_flags(sv)
    sv.add_argument("--num-images", type=int, default=500)
    sv.add_argument("--batch-size", type=int, default=100)
    sv.add_argument("--image", default=None, metavar="PATH",
                    help=f"input JPEG (default: {IMAGE_NAME} encoded at --quality)")
    sv.add_argument("--quality", type=int, default=90,
                    help="JPEG quality of the input stream and of the outputs")
    sv.add_argument("--decode-on-device", action="store_true",
                    help="the host decodes the entropy layer only; dequantize, "
                         "IDCT (K6), upsampling and colour run on the card")
    sv.add_argument("--encode-on-device", action="store_true",
                    help="the host encodes the entropy layer only; colour, "
                         "downsampling, fDCT and quantize (K7) run on the card "
                         "(byte-identical files)")
    sv.add_argument("--encode-subsampling", default="420", choices=DEVICE_SUBSAMPLINGS,
                    help="chroma subsampling of the emitted JPEGs")
    sv.add_argument("--encode-progressive", action="store_true",
                    help="progressive output streams (identical pixels)")
    sv.add_argument("--encode-arithmetic", action="store_true",
                    help="arithmetic-coded output streams (identical pixels)")
    sv.add_argument("--encode-optimize", action="store_true",
                    help="per-image optimal Huffman tables (identical pixels)")
    sv.add_argument("--encode-restart-interval", type=int, default=0, metavar="MCUS",
                    help="insert RSTn markers every MCUS MCUs (0 = none)")
    sv.add_argument("--decode-gray", action="store_true",
                    help="decode colour streams as grayscale at the source (libjpeg "
                         "JCS_GRAYSCALE: the luma's IDCT alone) and run 1-channel")
    sv.add_argument("--gray", action="store_true",
                    help="grayscale outputs: jccolor.c's luma on the card after the filter, "
                         "byte-identical to libjpeg's RGB -> grayscale encode")
    sv.add_argument("--thumbnail", action="store_true",
                    help="half-size outputs: filter, an exact 2x2 average (jcsample.c "
                         "rounding), encode")
    sv.add_argument("--resize", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="any output size: filter, the integer-exact Q14 bilinear resize, "
                         "encode")
    sv.add_argument("--colorize", default=None, metavar="BLACK:WHITE[:MID]",
                    help="map the grayscale output to a colour wedge (PIL "
                         "ImageOps.colorize, bit-exact; colours #rgb, #rrggbb, or names "
                         "where PIL is installed); needs --decode-gray or --gray")
    sv.add_argument("--decode-scale", type=int, default=1, choices=(1, 2, 4, 8),
                    help="DCT-domain scaled decode 1/N (libjpeg scale_num/denom, "
                         "bit-exact): the whole pipeline runs at ceil(dim/N)")
    sv.add_argument("--no-encode", action="store_true",
                    help="skip the output JPEG encode")
    sv.add_argument("--json", action="store_true",
                    help="print one JSON result line")
    sv.add_argument("--device", default="cuda",
                    help="device to run on (default: cuda; cpu runs the plain "
                         "versions)")
    _add_stats_flags(sv)
    tr = sub.add_parser("transform", help="lossless DCT-domain transform of JPEG files "
                                          "(the jpegtran analog)")
    tr.add_argument("input", nargs="+",
                    help="input JPEG path(s); several inputs take the batched path and "
                         "-o names a directory")
    tr.add_argument("op", choices=(*ALL_OPS, "crop"))
    tr.add_argument("--crop", type=int, nargs=4, default=None, metavar=("X", "Y", "W", "H"),
                    help="the region of op=crop (X and Y iMCU-aligned)")
    tr.add_argument("-o", "--output", required=True,
                    help="output JPEG path (a directory for several inputs)")
    tr.add_argument("--progressive", action="store_true")
    tr.add_argument("--arithmetic", action="store_true")
    tr.add_argument("--optimize", action="store_true")
    tr.add_argument("--device", default="cuda",
                    help="device of the coefficient ops (default: cuda; cpu runs them "
                         "on the host)")
    _add_approach_parsers(sub)
    return p


def _add_approach_parsers(sub) -> None:
    """``approach1`` and ``approach2``: hipe_tpu's grammar (its
    ``--accel-path`` excepted: the CUDA lane always runs the kernels)."""
    from hipe_tpu_torch.parallel import partitioner as pt

    a1 = sub.add_parser("approach1", help="image-level distribution over a "
                                          "host-CPU lane and a CUDA lane")
    a1.add_argument("mode", nargs="?", default="both",
                    choices=["both", "cpu", "gpu", "tpu", "accel"])
    a1.add_argument("gpu_ratio", nargs="?", type=float, default=pt.DEFAULT_RATIO)
    a1.add_argument("batch_size", nargs="?", type=int, default=pt.DEFAULT_BATCH)
    a2 = sub.add_parser("approach2", help="split-image distribution (rows, "
                                          "with a halo) over both lanes")
    a2.add_argument("gpu_ratio", nargs="?", type=float, default=pt.DEFAULT_RATIO)
    a2.add_argument("batch_size", nargs="?", type=int, default=pt.DEFAULT_BATCH)
    a2.add_argument("--save-output", default=None, metavar="PATH",
                    help="save the reassembled image 0 of batch 0 as a JPEG "
                         "(SAVE_IMAGE analog; needs libjpeg)")
    for sp in (a1, a2):
        sp.add_argument("--image", default=None,
                        help=f"input JPEG (default: {APPROACH_IMAGE_NAME}, the "
                             "reference's 320x240 geometry); comma-separate "
                             "paths for a mixed-resolution stream. Needs libjpeg")
        sp.add_argument("--num-images", type=int, default=pt.NUM_IMAGES)
        sp.add_argument("--pipeline", default="blur3",
                        help="a pipeline, a stage name, or a comma-joined "
                             "chain of stages")
        sp.add_argument("--no-profile", action="store_true",
                        help="skip stage timing (one sync a batch)")
        sp.add_argument("--pipeline-depth", type=int, default=1,
                        help="batches in flight per lane (1 = the reference's "
                             "per-batch barrier; 2 = double-buffered)")
        sp.add_argument("--scheduler", default="static", choices=["static", "greedy"],
                        help="static = fixed-ratio split (reference); greedy = "
                             "batch-level work stealing (approach 1 'both' only)")
        sp.add_argument("--elastic", action="store_true",
                        help="greedy only: survive a lane failure by "
                             "redistributing its batches to healthy lanes")
        sp.add_argument("--csv", default=None, metavar="PATH",
                        help="append a per_run.csv-schema row")
        sp.add_argument("--run-index", type=int, default=1)
        _add_stats_flags(sp)
        _add_register_flags(sp)


def _register_cli_kernels(specs) -> str | None:
    """Register --kernel NAME=TAPS[:SCALE[:OFFSET]] stages; error or None."""
    from hipe_tpu_torch.ops.blur import register_kernel_filter

    for raw in specs or ():
        head, eq, body = raw.partition("=")
        parts = body.split(":")
        try:
            if not eq or not head or len(parts) > 3:
                raise ValueError(
                    "expected NAME=T,T,...[:SCALE[:OFFSET]] (taps in PIL "
                    "ImageFilter.Kernel order; scale defaults to sum(taps))")
            taps = [int(t) for t in parts[0].split(",")]
            scale = int(parts[1]) if len(parts) > 1 and parts[1] else None
            offset = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
            register_kernel_filter(head, taps, scale, offset)
        except ValueError as e:
            return f"Error: bad --kernel {raw!r}: {e}"
    return None


def _register_cli_luts(specs) -> str | None:
    """Register --lut NAME=SPEC point stages; returns an error or None."""
    import numpy as np

    from hipe_tpu_torch.ops.blur import (brightness_lut, gamma_lut,
                                         register_lut_filter, solarize_lut)

    for raw in specs or ():
        head, eq, body = raw.partition("=")
        try:
            if not eq or not head:
                raise ValueError("expected NAME=brightness:F | NAME=gamma:G | "
                                 "NAME=solarize:T | NAME=v0,v1,...,v255")
            kind, sep, arg = body.partition(":")
            if sep and kind == "brightness":
                lut = brightness_lut(float(arg))
            elif sep and kind == "gamma":
                lut = gamma_lut(float(arg))
            elif sep and kind == "solarize":
                lut = solarize_lut(int(arg))
            elif sep:
                raise ValueError(f"unknown LUT constructor {kind!r} "
                                 "(brightness:F, gamma:G, or solarize:T)")
            else:
                lut = np.array([int(v) for v in body.split(",")])
            register_lut_filter(head, lut)
        except ValueError as e:
            return f"Error: bad --lut {raw!r}: {e}"
    return None


def _register_cli_ranks(specs) -> str | None:
    """Register --rank NAME=SIZE:RANK stages; returns an error or None."""
    from hipe_tpu_torch.ops.blur import register_rank_filter

    for raw in specs or ():
        head, eq, body = raw.partition("=")
        try:
            size, sep, rank = body.partition(":")
            if not eq or not head or not sep:
                raise ValueError("expected NAME=SIZE:RANK")
            register_rank_filter(head, int(size), int(rank))
        except ValueError as e:
            return f"Error: bad --rank {raw!r}: {e}"
    return None


def _stats_pipeline(args, name: str, channels: int = 3):
    """The GlobalStatsPipeline that --factor/--cutoff/--preserve-tone set for
    the pipeline ``name`` (None without them); ValueError on a misuse.
    ``hipe_tpu``'s checks: --factor takes contrast, color and sharpness,
    --cutoff (one or two integer percents) and --preserve-tone take
    autocontrast. Unlike ``hipe_tpu``'s ``stream``, which returns at the
    first flag it accepts, every flag given is checked."""
    from hipe_tpu_torch.models.pipelines import GlobalStatsPipeline

    if args.factor is None and args.cutoff is None and not args.preserve_tone:
        return None
    if args.factor is not None and name not in ("contrast", "color", "sharpness"):
        raise ValueError("--factor applies to contrast/color/sharpness only")
    if (args.cutoff is not None or args.preserve_tone) and (
            name != "autocontrast" or (args.cutoff is not None and len(args.cutoff) > 2)):
        raise ValueError("--cutoff/--preserve-tone apply to autocontrast only "
                         "(one or two integer percents / a flag)")
    if args.factor is not None:
        return GlobalStatsPipeline(name, factor=args.factor, channels=channels)
    cut = 0
    if args.cutoff is not None:
        cut = args.cutoff[0] if len(args.cutoff) == 1 else tuple(args.cutoff)
    return GlobalStatsPipeline("autocontrast", cutoff=cut, preserve_tone=args.preserve_tone,
                               channels=channels)


def _pipeline_of(args, spec: str, channels: int = 3):
    """Register the --kernel/--lut/--rank stages and resolve the pipeline
    ``spec``, with the settings of --factor/--cutoff/--preserve-tone for a
    global-statistics pipeline of ``channels``-channel planar inputs; prints
    one error line and returns None on a bad name, spec or setting."""
    from hipe_tpu_torch.models import pipelines as plib

    err = (_register_cli_kernels(args.kernel) or _register_cli_luts(args.lut)
           or _register_cli_ranks(args.rank))
    if err:
        print(err, file=sys.stderr)
        return None
    try:
        pipeline = plib.get(tuple(spec.split(",")) if "," in spec else spec)
    except (KeyError, ValueError) as e:
        msg = e.args[0] if e.args else str(e)
        print(f"Error: {msg} (a pipeline, a stage name, or a comma-joined "
              "chain of stages)", file=sys.stderr)
        return None
    try:
        return _stats_pipeline(args, spec, channels) or pipeline
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return None


def _describe(pipeline) -> str:
    """``name (stages ...)`` and a global-statistics pipeline's settings."""
    params = getattr(pipeline, "params", "")
    return (f"{pipeline.name} (stages {', '.join(pipeline.filters)})"
            + (f", {params}" if params else ""))


def _main_stream(args) -> int:
    import numpy as np
    import torch

    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu_torch.utils.images import checker_image

    pipeline = _pipeline_of(args, args.pipeline_name)
    if pipeline is None:
        return 1
    if args.image is None:
        source, image = IMAGE_NAME, checker_image(256, 256, 3, seed=0)
    else:
        from hipe_tpu_torch.io_.jpeg import decode_file

        source = args.image
        try:
            image = decode_file(args.image)
        except (OSError, ValueError) as e:
            print(f"Error: cannot load input image: {e}", file=sys.stderr)
            return 1
        except RuntimeError as e:  # the host codec's build (no g++ or libjpeg)
            print(f"Error: {str(e).splitlines()[0]}", file=sys.stderr)
            return 1
        image = np.ascontiguousarray(image if image.ndim == 3 else image[..., None])
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(
            f"Error: the stream runs on a CUDA device; got --device "
            f"{args.device} with torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}")
    card = gpu_name_and_power_limit()
    h, w, c = image.shape
    print("========== DEVICE-STREAM CONFIGURATION ==========")
    print(f"Pipeline: {_describe(pipeline)}")
    print(f"Stream: {args.num_images} images of {w}x{h}x{c} ({source})")
    print(f"Card: {card}")
    runner = DeviceStreamRunner(pipeline, num_images=args.num_images,
                                image=image, device=device)
    if not args.no_autotune:
        timings = runner.autotune(retune=args.retune)
        for label, t in sorted(timings.items(), key=lambda kv: kv[1]):
            print(f"  autotune {label:22s} {t * 1e3:8.3f} ms/pass")
        hit = (f" (stored in {runner.tune_cache_path}, sweep skipped)"
               if runner.tuning["cache_hit"] else "")
        print(f"Chosen config: {runner.tuning['chosen']}{hit}")
        for label, exc in runner.tuning["skipped"].items():
            print(f"  autotune skipped {label}: {exc}")
    err = runner.verify_max_abs_err()
    res = runner.measure_throughput(passes=args.passes, reps=3)
    print("\n========== DEVICE-STREAM RESULTS ==========")
    print(f"   Max-abs error vs oracle: {err}")
    print(f"   Per-pass time: {res['per_pass_s'] * 1e3:.4f} ms")
    print(f"   Overall throughput: {res['mpix_per_s']:.2f} Megapixels/sec")
    print(f"   Images per second: {res['img_per_s']:.2f}")
    print(f"   Effective memory bandwidth: {res['gb_per_s']:.1f} GB/s")
    if args.json:
        print(json.dumps({
            "pipeline": args.pipeline_name,
            "filters": list(pipeline.filters),
            "params": getattr(pipeline, "params", ""),
            "num_images": args.num_images,
            "image": source,
            "img_per_s": res["img_per_s"],
            "per_pass_ms": res["per_pass_s"] * 1e3,
            "gb_per_s": res["gb_per_s"],
            "max_abs_err": err,
            "config": (runner.tuning or {}).get("chosen", "default"),
            "device": torch.cuda.get_device_name(device),
            "card": card,
        }))
    # Exact equality is the contract: any nonzero error is a kernel fault.
    return 0 if err == 0 else 1


def _main_serve(args) -> int:
    """JPEG decode -> filter -> encode over a stream of JPEGs."""
    import torch

    from hipe_tpu_torch.io_ import jpeg as jio
    from hipe_tpu_torch.runtime.serve import ServingPipeline
    from hipe_tpu_torch.utils.images import checker_image

    # Under --decode-gray the pipeline runs 1-channel (hipe_tpu's channels=1).
    pipeline = _pipeline_of(args, args.pipeline_name, 1 if args.decode_gray else 3)
    if pipeline is None:
        return 1
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"Error: serve runs on a CUDA device unless --device cpu; got --device "
            f"{args.device} with torch.cuda.is_available() = False")
    try:
        if args.image is None:
            source = IMAGE_NAME
            payload = jio.encode_bytes(checker_image(256, 256, 3, seed=0), args.quality)
        else:
            source = args.image
            with open(args.image, "rb") as f:
                payload = jio.encode_bytes(jio.decode_bytes(f.read()), args.quality)
    except (OSError, ValueError) as e:
        print(f"Error: cannot load input image: {e}", file=sys.stderr)
        return 1
    except RuntimeError as e:
        print(f"Error: {str(e).splitlines()[0]}", file=sys.stderr)
        return 1
    batch = max(1, min(args.batch_size, args.num_images))
    card = gpu_name_and_power_limit() if device.type == "cuda" else "cpu"
    print("========== SERVING CONFIGURATION ==========")
    print(f"Pipeline: {_describe(pipeline)}")
    print(f"Stream: {args.num_images} JPEGs of {source}, batch {batch}, "
          f"quality {args.quality}")
    print("Decode: " + ("device (entropy on the host, IDCT K6/upsample/colour on the card)"
                        if args.decode_on_device else "host (native libjpeg)"))
    if not args.no_encode:
        print("Encode: " + ("device (colour/downsample/fDCT K7/quantize on the card, "
                            "entropy on the host)" if args.encode_on_device
                            else "host (native libjpeg)"))
    if args.thumbnail:
        print("Output: half-size thumbnails (exact 2x2 average)")
    if args.decode_scale > 1:
        print(f"Decode scale: 1/{args.decode_scale} (DCT-domain, bit-exact vs libjpeg "
              "scaled decode)")
    colorize = None
    if args.colorize is not None:
        from hipe_tpu_torch.ops.equalize import colorize_lut

        parts = args.colorize.split(":")
        if len(parts) not in (2, 3):
            print("Error: --colorize takes BLACK:WHITE or BLACK:WHITE:MID colors",
                  file=sys.stderr)
            return 1
        if not (args.decode_gray or args.gray):
            print("Error: --colorize needs a grayscale stage output; combine it with "
                  "--decode-gray or --gray", file=sys.stderr)
            return 1
        try:
            colorize = colorize_lut(*parts)
        except ValueError as e:
            print(f"Error: bad --colorize: {e}", file=sys.stderr)
            return 1
        print(f"Colorize: {' -> '.join(parts)} (PIL ImageOps.colorize, bit-exact)")
    print(f"Card: {card}")
    try:
        serve = ServingPipeline(
            pipeline, device=device, quality=args.quality,
            decode_on_device=args.decode_on_device, encode_on_device=args.encode_on_device,
            encode_subsampling=args.encode_subsampling,
            encode_progressive=args.encode_progressive,
            encode_arithmetic=args.encode_arithmetic,
            encode_restart_interval=args.encode_restart_interval,
            encode_optimize=args.encode_optimize,
            output_scale=2 if args.thumbnail else 1,
            resize_to=tuple(args.resize) if args.resize else None,
            decode_scale=args.decode_scale, gray_output=args.gray,
            decode_gray=args.decode_gray, colorize=colorize)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    def batches():
        sent = 0
        while sent < args.num_images:
            n = min(batch, args.num_images - sent)
            yield [payload] * n
            sent += n

    with serve:
        n_out = sum(len(r) for r in serve.run(batches(), encode=not args.no_encode))
    st = serve.stats
    print("\n========== SERVING RESULTS ==========")
    print(f"   Images processed: {n_out}")
    print(f"   Host decode time: {st.decode_ms:.1f} ms")
    print(f"   Device time: {st.device_ms:.1f} ms")
    print(f"   Encode time: {st.encode_ms:.1f} ms")
    print(f"   Wall time: {st.wall_ms:.1f} ms")
    print(f"   Images per second: {st.img_per_s:.2f}")
    if args.json:
        print(json.dumps({
            "pipeline": args.pipeline_name,
            "num_images": n_out,
            "decode_on_device": bool(args.decode_on_device),
            "encode_on_device": bool(args.encode_on_device),
            "img_per_s": st.img_per_s,
            "decode_ms": st.decode_ms,
            "device_ms": st.device_ms,
            "encode_ms": st.encode_ms,
            "wall_ms": st.wall_ms,
            "device": str(device),
            "card": card,
        }))
    return 0 if n_out == args.num_images else 1


def _main_transform(args) -> int:
    """Lossless DCT-domain transform of JPEG files (the jpegtran analog)."""
    import os

    from hipe_tpu_torch.ops.jpeg_transform import crop_bytes, transform_batch, transform_bytes

    opts = dict(progressive=args.progressive, arithmetic=args.arithmetic,
                optimize=args.optimize)
    try:
        datas = []
        for path in args.input:
            with open(path, "rb") as f:
                datas.append(f.read())
        if args.op == "crop":
            if args.crop is None:
                raise ValueError("op=crop requires --crop X Y W H")
            outs = [crop_bytes(d, *args.crop, **opts) for d in datas]
        elif len(datas) > 1:
            outs = transform_batch(datas, args.op, device=args.device, **opts)
        else:
            outs = [transform_bytes(datas[0], args.op, device=args.device, **opts)]
    except (OSError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    except RuntimeError as e:  # no CUDA device, or no g++ or libjpeg to build the codec
        print(f"Error: {str(e).splitlines()[0]}")
        return 1
    if len(args.input) > 1:
        names = [os.path.basename(p) for p in args.input]
        if len(set(names)) != len(names):
            print("Error: input basenames collide; outputs would overwrite each other in "
                  "the output directory")
            return 1
        os.makedirs(args.output, exist_ok=True)
        for name, out in zip(names, outs):
            with open(os.path.join(args.output, name), "wb") as f:
                f.write(out)
        print(f"{args.op}: {len(datas)} files -> {args.output}/ "
              f"({sum(len(d) for d in datas)} -> {sum(len(o) for o in outs)} bytes, "
              "lossless)")
    else:
        with open(args.output, "wb") as f:
            f.write(outs[0])
        print(f"{args.op}: {args.input[0]} -> {args.output} "
              f"({len(datas[0])} -> {len(outs[0])} bytes, lossless)")
    return 0


def _main_approach(args) -> int:
    """approach1 / approach2: the heterogeneous engine over a stream."""
    import numpy as np

    from hipe_tpu_torch.parallel import mesh as meshlib
    from hipe_tpu_torch.parallel import partitioner as pt
    from hipe_tpu_torch.profiling.report import CSV_COLUMNS, to_csv_row
    from hipe_tpu_torch.runtime.engine import Engine, EngineConfig
    from hipe_tpu_torch.utils.images import checker_image

    pipeline = _pipeline_of(args, args.pipeline)
    if pipeline is None:
        return 1
    approach = 1 if args.command == "approach1" else 2
    if approach == 2:
        try:
            pipeline.radius
        except ValueError as e:
            # A global-statistics pipeline has no halo radius; the row split
            # cannot run it (the error says what can).
            print(f"Error: {e}", file=sys.stderr)
            return 1
    cfg = EngineConfig(
        approach=approach, mode=getattr(args, "mode", "both"),
        gpu_ratio=args.gpu_ratio, batch_size=args.batch_size,
        num_images=args.num_images, pipeline=pipeline,
        profile=not args.no_profile, pipeline_depth=args.pipeline_depth,
        scheduler=args.scheduler, elastic=args.elastic,
        save_output=getattr(args, "save_output", None), verbose=True,
    ).validate()
    if args.image is None:
        paths, images = [APPROACH_IMAGE_NAME], [checker_image(240, 320, 3, seed=0)]
    else:
        from hipe_tpu_torch.io_.jpeg import decode_file

        paths = args.image.split(",")
        try:
            images = [np.ascontiguousarray(decode_file(p)) for p in paths]
        except (OSError, ValueError) as e:
            print(f"Error: cannot load input image: {e}", file=sys.stderr)
            return 1
        except RuntimeError as e:  # the host codec's build (no g++ or libjpeg)
            print(f"Error: {str(e).splitlines()[0]}", file=sys.stderr)
            return 1
    n_batches = pt.num_batches(cfg.num_images, cfg.batch_size)
    name = "HETEROGENEOUS" if approach == 1 else "SPLIT-IMAGE"
    print(f"========== {name} CONFIGURATION ==========")
    print(f"Input: {args.image or APPROACH_IMAGE_NAME}")
    print(f"Number of images in stream: {cfg.num_images}")
    print(f"Batch size: {cfg.batch_size} images")
    print(f"Number of batches: {n_batches}")
    print(f"Pipeline: {_describe(pipeline)}")
    if approach == 1:
        print(f"Mode: {cfg.mode}")
        print(f"GPU ratio: {cfg.gpu_ratio * 100:.1f}% GPU, "
              f"{(1 - cfg.gpu_ratio) * 100:.1f}% CPU")
    else:
        print(f"GPU ratio: {cfg.gpu_ratio * 100:.1f}% (rows to the GPU)")
    print("================================================\n")
    image = images[0]
    h, w, c = image.shape
    for p, im in zip(paths, images):
        ih, iw, ic = im.shape
        print(f"Original image loaded: {iw}x{ih}, {ic} channels ({p})")
    print(f"Size of one image: {image.nbytes} bytes ({image.nbytes / 1024.0:.2f} KB)\n")
    print(meshlib.discover().describe())
    if approach == 2:
        rs = pt.row_split(h, cfg.gpu_ratio, halo=pipeline.radius)
        print("\nSplit configuration:")
        print(f"  Split row: {rs.split_row} (CPU: rows 0-{rs.split_row - 1}, "
              f"GPU: rows {rs.split_row}-{h - 1})")
        print(f"  CPU: {rs.cpu_input_rows} input rows (inc. halo), "
              f"{rs.cpu_output_rows} output rows")
        print(f"  GPU: {rs.gpu_input_rows} input rows (inc. halo), "
              f"{rs.gpu_output_rows} output rows")
    try:
        engine = Engine(cfg)
    except RuntimeError as e:
        # Modes 'both' and 'gpu' need a card; the CPU lane never stands in.
        raise SystemExit(f"{e} (mode {cfg.mode} runs a CUDA lane; "
                         "torch.cuda.is_available() is False)") from e
    print(f"\nStarting batch processing of {cfg.num_images} images in "
          f"{n_batches} batches...")
    if len(images) > 1:
        from hipe_tpu_torch.runtime.stream import MixedResolutionStream

        stats = engine.run(stream=MixedResolutionStream(images, cfg.num_images,
                                                        cfg.batch_size))
    else:
        stats = engine.run(image=image)
    print("\nAll batches finished!")
    print(engine.report())
    print(f"Card: {gpu_name_and_power_limit()}")
    if args.csv:
        row = to_csv_row(stats, run=args.run_index, file=args.csv)
        try:
            with open(args.csv) as f:
                write_header = not f.readline().strip()
        except FileNotFoundError:
            write_header = True
        with open(args.csv, "a", newline="") as f:
            wtr = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
            if write_header:
                wtr.writeheader()
            wtr.writerow(row)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "stream":
        return _main_stream(args)
    if args.command == "serve":
        return _main_serve(args)
    if args.command == "transform":
        return _main_transform(args)
    return _main_approach(args)


if __name__ == "__main__":
    sys.exit(main())
