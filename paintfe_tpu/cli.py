"""Headless CLI batch mode.

Behavioral contract: src/cli.rs — flags (-i/--input globs, -s/--script,
-o/--output, --output-dir, -f/--format, -q/--quality, --webp-lossy,
--tiff-compression, --flatten, -v/--verbose), glob resolve/dedup
(cli.rs:315-350), per-file pipeline load -> script on active layer ->
canvas-op replay -> flatten -> encode (cli.rs:222-303), format inference
(cli.rs:354-390), collision-safe `_out` suffix (cli.rs:399-427), exit code
0 all-ok / 1 any-failure with keep-going semantics (cli.rs:155-216).

Addition over the reference: `--shard` distributes the batch loop over
the device mesh via paintfe_tpu.parallel (the reference loops serially).
"""

from __future__ import annotations

import argparse
import glob as globlib
import os
import pathlib
import sys
import time
from typing import List, Optional

import numpy as np

from paintfe_tpu.core.canvas import Canvas, canonicalize_tiles
from paintfe_tpu.io import codecs, deep_export, pfe
from paintfe_tpu.io.pdn import PdnError
from paintfe_tpu.io.raw import RawError
from paintfe_tpu.scripting import ScriptError, apply_canvas_ops, execute_script_sync

# per-file keep-going: every error class an input file can legitimately
# produce (cli.rs:155-216 prints and continues; a class missing here
# crashes the whole batch)
_INPUT_ERRORS = (codecs.CodecError, pfe.PfeError, PdnError, RawError,
                 ScriptError, OSError, ValueError)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paintfe-tpu",
        description="PaintFE-compatible headless batch processor (JAX)",
    )
    p.add_argument("-i", "--input", nargs="+", action="extend", required=True,
                   help="input file(s); glob patterns accepted; the flag "
                        "may be repeated (cli.rs:43-48 semantics)")
    p.add_argument("-s", "--script", metavar="SCRIPT.rhai",
                   help="script to execute on each input image")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="output path (single-file input only)")
    p.add_argument("--output-dir", metavar="DIR",
                   help="output directory for batch processing")
    p.add_argument("-f", "--format",
                   help="png, jpeg, webp, bmp, tga, ico, tiff, gif, pfe")
    p.add_argument("-q", "--quality", type=int, default=90, metavar="1-100")
    p.add_argument("--webp-lossy", action="store_true",
                   help="write WebP lossily using --quality")
    p.add_argument("--tiff-compression", default="none",
                   choices=["none", "lzw", "deflate"])
    p.add_argument("--flatten", action=argparse.BooleanOptionalAction, default=True,
                   help="flatten visible layers before saving")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings (load/script/flatten/encode)")
    p.add_argument("--trace-dir", metavar="DIR",
                   help="write a jax.profiler trace of the run to DIR")
    p.add_argument("--shard", action="store_true",
                   help="shard the batch across available accelerator devices")
    p.add_argument("--animate", metavar="OUT",
                   help="combine all processed inputs into one animated "
                        "GIF/APNG/WebP at OUT (each input = one frame)")
    p.add_argument("--fps", type=float, default=10.0,
                   help="frame rate for --animate (default 10)")
    return p


def resolve_inputs(patterns: List[str]) -> List[pathlib.Path]:
    """Literal paths first, else glob expansion; ordered, deduplicated."""
    result: List[pathlib.Path] = []
    for pattern in patterns:
        as_path = pathlib.Path(pattern)
        if as_path.exists():
            if as_path not in result:
                result.append(as_path)
            continue
        matches = sorted(globlib.glob(pattern))
        if not matches:
            print(f"warning: pattern '{pattern}' matched no files.", file=sys.stderr)
        for m in matches:
            mp = pathlib.Path(m)
            if mp not in result:
                result.append(mp)
    return result


_EXT_FORMATS = {
    "jpg": "jpeg", "jpeg": "jpeg", "webp": "webp", "bmp": "bmp", "tga": "tga",
    "ico": "ico", "tiff": "tiff", "tif": "tiff", "gif": "gif", "pfe": "pfe",
}


def parse_format(format_arg: Optional[str], output: Optional[str]) -> str:
    if format_arg:
        return _EXT_FORMATS.get(format_arg.lower(), "png")
    if output:
        ext = pathlib.Path(output).suffix.lower().lstrip(".")
        return _EXT_FORMATS.get(ext, "png")
    return "png"


def build_output_path(input_path: pathlib.Path, output: Optional[str],
                      output_dir: Optional[str], fmt: str) -> pathlib.Path:
    if output:
        return pathlib.Path(output)
    ext = codecs.format_extension(fmt)
    stem = input_path.stem
    if output_dir:
        return pathlib.Path(output_dir) / f"{stem}.{ext}"
    parent = input_path.parent
    candidate = parent / f"{stem}.{ext}"
    if candidate == input_path:
        return parent / f"{stem}_out.{ext}"
    return candidate


def load_canvas(path: pathlib.Path) -> Canvas:
    if path.suffix.lower() == ".pfe":
        return pfe.load_pfe(str(path))
    if path.suffix.lower() == ".pdn":
        from paintfe_tpu.io import pdn

        return pdn.load_pdn(str(path))
    deep = deep_export.load_deep_image(path)
    if deep is not None:  # 16-bit PNG / 16/32-bit TIFF keep the deep payload
        preview, pixel_format, buf = deep
        canvas = Canvas.from_image(preview)
        canvas.layers[0].pixel_format = pixel_format
        canvas.layers[0].deep_pixels = buf
        return canvas
    img = codecs.load_image(path)
    return Canvas.from_image(img)


def _commit_script_result(canvas, idx, result, new_w, new_h, canvas_ops):
    """Commit a script's u8 result to the active layer: canonicalize
    transparent tiles (the layer-commit invariant, canvas.py:43), replay
    canvas-wide ops on the other layers, fix dims — and keep the deep
    payload consistent: a changed u8 result (or new dims) rebuilds the
    deep buffer from it, since the script semantics are u8 (a stale deep
    buffer of the OLD element count crashed the 16-bit export path)."""
    layer = canvas.layers[idx]
    old_pixels = layer.pixels
    new_pixels = canonicalize_tiles(
        np.asarray(result, np.uint8).reshape(new_h, new_w, 4)
    )
    if layer.deep_pixels is not None and (
            new_pixels.shape != old_pixels.shape
            or not np.array_equal(new_pixels, old_pixels)):
        from paintfe_tpu.core.deep import DeepRgbaBuffer, PixelFormat

        fmt = (PixelFormat(layer.pixel_format) if layer.pixel_format
               is not None else PixelFormat.RGBA_U8)
        layer.deep_pixels = DeepRgbaBuffer.from_rgba8(new_pixels, fmt)
    layer.pixels = new_pixels
    if canvas_ops:
        apply_canvas_ops(canvas, canvas_ops, skip_layer=idx)
    canvas.width, canvas.height = new_w, new_h


def run_one(input_path: pathlib.Path, output_path: pathlib.Path,
            script_source: Optional[str], fmt: str, quality: int,
            webp_lossless: bool, tiff_compression: str, flatten: bool,
            verbose: bool, timer=None):
    from paintfe_tpu.utils.profiling import StageTimer

    if timer is None:
        timer = StageTimer()
    with timer.stage("load"):
        canvas = load_canvas(input_path)

    if script_source is not None:
        idx = canvas.active_layer_index
        mask = canvas.selection
        with timer.stage("script"):
            result, new_w, new_h, console, canvas_ops = execute_script_sync(
                script_source, canvas.layers[idx].pixels,
                canvas.width, canvas.height, mask
            )
        if verbose:
            for line in console:
                print(f"  [script] {line}")
        _commit_script_result(canvas, idx, result, new_w, new_h, canvas_ops)

    if fmt == "pfe":
        pfe.save_pfe(canvas, str(output_path))
        return

    # dirty text layers rasterize before any flatten/encode (cli.rs:275
    # state.ensure_all_text_layers_rasterized)
    from paintfe_tpu.ops.text_layer import ensure_text_layers_rasterized

    ensure_text_layers_rasterized(canvas)

    if flatten and (len(canvas.layers) > 1 or deep_export.needs_deep_export(canvas)):
        # depth-aware export: deep/HDR layers route to 16-bit PNG or
        # 16/32-bit TIFF (io.rs:1413-1453, :1588-1631); plain single-layer
        # documents skip the compositor entirely (cli.rs:282-293)
        with timer.stage("flatten"):
            prep = deep_export.prepare_export_image(canvas)
        with timer.stage("encode"):
            deep_export.encode_prepared_and_write(
                prep, output_path, fmt, quality=quality,
                tiff_compression=tiff_compression, webp_lossless=webp_lossless,
            )
        return
    with timer.stage("encode"):
        codecs.save_image(
            canvas.active_layer.pixels, output_path, fmt, quality=quality,
            webp_lossless=webp_lossless, tiff_compression=tiff_compression,
        )


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    # Persistent XLA compilation cache: a fresh process re-jits everything
    # otherwise.
    # The reference CLI is a native binary with zero warmup (cli.rs:105-216);
    # this gets cold invocations to executable-deserialization cost instead.
    from paintfe_tpu.utils.compile_cache import cache_report, enable_persistent_cache

    cache_dir = enable_persistent_cache()
    if args.verbose and cache_dir:
        print(f"[cache] XLA compilation cache at {cache_dir}")

    inputs = resolve_inputs(args.input)
    if not inputs:
        print("error: no input files matched the given pattern(s).", file=sys.stderr)
        return 1
    if len(inputs) > 1 and args.output and not args.output_dir:
        print(
            f"error: {len(inputs)} input files given but --output only accepts a "
            "single file path.\nUse --output-dir for batch processing.",
            file=sys.stderr,
        )
        return 1

    fmt = parse_format(args.format, args.output)

    script_source = None
    if args.script:
        try:
            script_source = pathlib.Path(args.script).read_text()
        except OSError as e:
            print(f"error: could not read script '{args.script}': {e}", file=sys.stderr)
            return 1

    if args.output_dir:
        pathlib.Path(args.output_dir).mkdir(parents=True, exist_ok=True)

    if args.animate:
        return _run_animate(inputs, args, script_source)

    # Engage the sharded path whenever --shard was asked for (any input
    # count — shard_inputs handles length-1 lists) OR the process was
    # launched as part of an explicitly-wired multi-process job: without
    # this, every host would process the same files, write the same
    # outputs concurrently, and exit codes would never be agreed.
    if args.shard or os.environ.get("PAINTFE_COORDINATOR"):
        from paintfe_tpu.parallel import distributed
        from paintfe_tpu.parallel.batch import run_sharded_batch

        # Multi-host launch (PAINTFE_COORDINATOR/NUM_PROCESSES/PROCESS_ID or
        # cluster auto-detect): each host takes its deterministic slice of
        # the glob list and runs it on its local devices; exit codes are
        # agreed globally so every process reports any peer's failure.
        multi_host = distributed.maybe_initialize(verbose=args.verbose)
        if multi_host:
            inputs = distributed.shard_inputs(inputs)
            if args.verbose:
                print(f"[distributed] this host handles {len(inputs)} input(s)")
            rc = run_sharded_batch(inputs, args, fmt, script_source) if inputs else 0
            return 0 if distributed.all_processes_ok(rc == 0) else 1
        return run_sharded_batch(inputs, args, fmt, script_source)

    from paintfe_tpu.utils.profiling import StageTimer, jax_trace

    total = len(inputs)
    multi = total > 1
    any_failure = False
    # `with` (not manual __enter__/__exit__): an unexpected escape or
    # KeyboardInterrupt must still finalize the --trace-dir profile
    with jax_trace(args.trace_dir):
        for i, input_path in enumerate(inputs):
            if multi or args.verbose:
                print(f"[{i + 1}/{total}] {input_path}")
            t0 = time.time()
            output_path = build_output_path(input_path, args.output,
                                            args.output_dir, fmt)
            timer = StageTimer() if args.profile else None
            try:
                run_one(
                    input_path, output_path, script_source, fmt, args.quality,
                    not args.webp_lossy, args.tiff_compression, args.flatten,
                    args.verbose, timer=timer,
                )
                if args.verbose or multi:
                    print(f"  -> {output_path} ({(time.time() - t0) * 1000:.0f}ms)")
                if timer is not None:
                    print(timer.report())
            except _INPUT_ERRORS as e:
                msg = e
                if isinstance(e, ScriptError):
                    msg = f"script error: {e}"
                print(f"  error: {msg}", file=sys.stderr)
                any_failure = True
    if args.profile:
        print(cache_report())
    return 1 if any_failure else 0


def _compute_frame(input_path, script_source):
    """One input -> processed flattened frame (the --animate unit of work;
    may raise any of _INPUT_ERRORS)."""
    canvas = load_canvas(input_path)
    if script_source is not None:
        idx = canvas.active_layer_index
        result, new_w, new_h, _console, canvas_ops = execute_script_sync(
            script_source, canvas.layers[idx].pixels,
            canvas.width, canvas.height, canvas.selection,
        )
        # same commit path as run_one (canonicalize + deep sync)
        _commit_script_result(canvas, idx, result, new_w, new_h, canvas_ops)
    from paintfe_tpu.ops.text_layer import ensure_text_layers_rasterized

    ensure_text_layers_rasterized(canvas)
    return (canvas.composite() if len(canvas.layers) > 1
            else canvas.active_layer.pixels)


def _run_animate(inputs, args, script_source) -> int:
    """Process every input, then encode all frames as one animation
    ("each visible layer = one frame" semantics applied to the batch).

    With --shard, frame computation runs through the bucketed mesh engine
    (the BASELINE "sharded batch -> per-frame animated export" target) —
    frames are bit-identical to this serial path and come back in input
    order."""
    ext = pathlib.Path(args.animate).suffix.lower().lstrip(".")
    anim_fmt = {"gif": "gif", "png": "apng", "apng": "apng", "webp": "webp"}.get(ext)
    if anim_fmt is None:
        print(f"error: --animate needs a .gif/.png/.webp path, got '{ext}'",
              file=sys.stderr)
        return 1
    if args.shard:
        from paintfe_tpu.parallel.batch import run_sharded_frames

        frames, any_failure = run_sharded_frames(inputs, args, script_source)
    else:
        frames = []
        any_failure = False
        for input_path in inputs:
            try:
                frames.append(_compute_frame(input_path, script_source))
            except _INPUT_ERRORS as e:
                print(f"  error: {e}", file=sys.stderr)
                any_failure = True
    if not frames:
        return 1
    try:
        codecs.save_animation(frames, args.animate, anim_fmt, fps=args.fps,
                              quality=args.quality,
                              webp_lossless=not args.webp_lossy)
        if args.verbose:
            print(f"  -> {args.animate} ({len(frames)} frames @ {args.fps} fps)")
    except codecs.CodecError as e:
        print(f"  error: {e}", file=sys.stderr)
        return 1
    return 1 if any_failure else 0


if __name__ == "__main__":
    sys.exit(main())
