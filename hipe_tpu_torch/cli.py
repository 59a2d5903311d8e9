"""Command line of the PyTorch/CUDA port (counterpart of ``hipe_tpu.cli``).

This slice carries the ``stream`` subcommand, the device-resident stream on
an NVIDIA GPU. It takes a pipeline name, a bare stage name or a comma-joined
chain of stages; ``--kernel``, ``--lut`` and ``--rank`` register stages
with ``hipe_tpu``'s grammar::

    python -m hipe_tpu_torch.cli stream blur3 --num-images 5000 --json
    python -m hipe_tpu_torch.cli stream chain --num-images 5000 --json
    python -m hipe_tpu_torch.cli stream denoise --num-images 5000 --json
    python -m hipe_tpu_torch.cli stream gaussian3,sharpen,edge --json
    python -m hipe_tpu_torch.cli stream dim,gaussian3 --lut dim=brightness:0.7
    python -m hipe_tpu_torch.cli stream q,edge --rank q=5:6
    python -m hipe_tpu_torch.cli stream soft,sharpen --kernel soft=1,2,1,2,4,2,1,2,1:16

The stream's image is ``checker_image(256, 256, 3, seed=0)``; the port has
no JPEG codec yet. Without a CUDA device the command fails: it never runs
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

IMAGE_NAME = "checker_image(256,256,3,seed=0)"


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hipe_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    st = sub.add_parser("stream", help="device-resident stream on the GPU")
    st.add_argument("pipeline_name", nargs="?", default="blur3",
                    help="a pipeline, a stage name, or a comma-joined chain "
                         "of stages")
    st.add_argument(
        "--kernel", action="append", metavar="NAME=TAPS[:SCALE[:OFFSET]]",
        help="register a custom convolution kernel as a chainable filter "
             "stage (taps comma-separated in PIL ImageFilter.Kernel order, "
             "odd square 3x3-9x9; scale defaults to sum(taps); offset in "
             "halves). Repeatable. Example: "
             "--kernel soft=1,2,1,2,4,2,1,2,1:16 soft,sharpen")
    st.add_argument(
        "--lut", action="append", metavar="NAME=SPEC",
        help="register a 256-entry LUT as a chainable radius-0 point stage. "
             "SPEC is brightness:F (PIL ImageEnhance.Brightness, bit-exact), "
             "gamma:G, solarize:T (PIL threshold), or 256 comma-separated "
             "uint8 values. Repeatable. Example: --lut dim=brightness:0.7 "
             "dim,gaussian3")
    st.add_argument(
        "--rank", action="append", metavar="NAME=SIZE:RANK",
        help="register PIL RankFilter(SIZE, RANK) as a chainable stage "
             "(SIZE odd 3..9, RANK in [0, SIZE^2); bit-exact incl. borders; "
             "median5/erode5/dilate5/median7/median9 are pre-registered). "
             "Repeatable. Example: --rank q=5:6 q,edge")
    st.add_argument("--num-images", type=int, default=5000)
    st.add_argument("--passes", type=int, default=10)
    st.add_argument("--no-autotune", action="store_true",
                    help="skip the measured rows_per_block selection")
    st.add_argument("--json", action="store_true",
                    help="print one JSON result line")
    st.add_argument("--device", default="cuda",
                    help="CUDA device to run on (default: cuda)")
    return p


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


def _main_stream(args) -> int:
    import torch

    from hipe_tpu_torch.models import pipelines as plib
    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu_torch.utils.images import checker_image

    err = (_register_cli_kernels(args.kernel) or _register_cli_luts(args.lut)
           or _register_cli_ranks(args.rank))
    if err:
        print(err, file=sys.stderr)
        return 1
    spec = args.pipeline_name
    try:
        pipeline = plib.get(tuple(spec.split(",")) if "," in spec else spec)
    except (KeyError, ValueError) as e:
        msg = e.args[0] if e.args else str(e)
        print(f"Error: {msg} (a pipeline, a stage name, or a comma-joined "
              "chain of stages)", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(
            f"Error: the stream runs on a CUDA device; got --device "
            f"{args.device} with torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}")
    card = gpu_name_and_power_limit()
    image = checker_image(256, 256, 3, seed=0)
    h, w, c = image.shape
    print("========== DEVICE-STREAM CONFIGURATION ==========")
    print(f"Pipeline: {args.pipeline_name} (stages {', '.join(pipeline.filters)})")
    print(f"Stream: {args.num_images} images of {w}x{h}x{c} ({IMAGE_NAME})")
    print(f"Card: {card}")
    runner = DeviceStreamRunner(pipeline, num_images=args.num_images,
                                image=image, device=device)
    if not args.no_autotune:
        timings = runner.autotune()
        for label, t in sorted(timings.items(), key=lambda kv: kv[1]):
            print(f"  autotune {label:22s} {t * 1e3:8.3f} ms/pass")
        print(f"Chosen config: {runner.tuning['chosen']}")
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
            "num_images": args.num_images,
            "image": IMAGE_NAME,
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "stream":
        return _main_stream(args)
    raise AssertionError(args.command)


if __name__ == "__main__":
    sys.exit(main())
