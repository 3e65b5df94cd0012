"""Sharded CLI batch runner: the reference's serial glob loop (cli.rs:159)
re-expressed as mesh-sharded batches.

Strategy: trace the script's op chain once (pipeline.trace_script); bucket
inputs by dimensions so each bucket is one static-shape [N, H, W, 4] batch;
run each bucket through the fused chain sharded over the device mesh;
encode results on the host.  Scripts that touch pixels directly fall back
to the per-image interpreter path, still with keep-going semantics.
"""

from __future__ import annotations

import pathlib
import sys
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np

from paintfe_tpu.io import codecs
from paintfe_tpu.parallel.pipeline import NotVectorizable, run_batch, trace_script


FLUSH_AT = 64  # compute a shape bucket once this many images accumulate


_PROC_POOL = None


def _proc_pool():
    """Singleton spawn-context encode pool: worker startup amortizes
    across every sharded run in the process (bench runs, the server
    daemon, multi-glob CLI invocations)."""
    global _PROC_POOL
    if _PROC_POOL is None:
        import concurrent.futures
        import multiprocessing

        _PROC_POOL = concurrent.futures.ProcessPoolExecutor(
            max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    return _PROC_POOL


def run_sharded_batch(inputs: List[pathlib.Path], args, fmt: str,
                      script_source: Optional[str]) -> int:
    from paintfe_tpu.cli import build_output_path, run_one

    ops = []
    per_bucket_trace = False
    if script_source:
        try:
            ops = trace_script(script_source)
        except NotVectorizable as e:
            if str(e) in ("width", "height"):
                # dimension-derived op params: the chain is still a pure op
                # chain, but must be re-traced per shape bucket so width()/
                # height() report the REAL dims (a 1x1 dummy trace would
                # silently bake wrong parameters)
                per_bucket_trace = True
            else:
                if args.verbose:
                    print(f"note: script uses per-pixel API ({e}); "
                          "running per-image")
                return _fallback_serial(inputs, args, fmt, script_source)
        except Exception as e:
            print(f"  error: script error: {e}", file=sys.stderr)
            return 1

    state = {"failed": False, "done": 0}
    t0 = time.time()

    # Encode-behind pool, the mirror image of the prefetch decode pool.
    # Encoders that hold the GIL (Pillow's) need PROCESSES for real
    # overlap on the heavy frames; the spawn workers pay a one-time import
    # of the JAX-free codec modules, so small frames (tests, thumbnails)
    # stay on a thread pool where the GIL loss is cheaper than the spawn.
    # Files are distinct, so order is free; results drain at the end for
    # keep-going accounting.
    import concurrent.futures

    thread_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    proc_pool = None
    encodes = []
    PROC_THRESHOLD = 512 * 1024  # pixels; ~0.5 Mpix

    def _encode_args(idx):
        output_path = build_output_path(inputs[idx], args.output,
                                        args.output_dir, fmt)
        return (str(output_path), fmt, args.quality, not args.webp_lossy,
                args.tiff_compression)

    # cap on in-flight encode futures: each holds a full output frame, so
    # an unbounded queue on a 1k-image 4-Mpix job would pin ~16 GB of
    # frames in host memory while the chip races ahead of the encoders —
    # the same bounded-window discipline the decode prefetcher applies
    ENCODE_WINDOW = 16

    def _settle(fut):
        try:
            ok, msg = fut.result()
        except Exception as e:  # worker crash (BrokenProcessPool...)
            ok, msg = False, f"  error: encode worker failed: {e}"
        if ok:
            state["done"] += 1
            if args.verbose:
                print(msg)
        else:
            print(msg, file=sys.stderr)
            state["failed"] = True

    def save_one(idx, img):
        nonlocal proc_pool
        while len(encodes) >= ENCODE_WINDOW:
            _settle(encodes.pop(0))
        eargs = _encode_args(idx)
        if img.shape[0] * img.shape[1] >= PROC_THRESHOLD:
            if proc_pool is None:
                try:
                    proc_pool = _proc_pool()
                except (OSError, ValueError):
                    proc_pool = thread_pool  # restricted platforms
            try:
                encodes.append(proc_pool.submit(
                    codecs.encode_job, np.asarray(img), *eargs))
                return
            except Exception:
                pass  # pickling/pool failure: fall through to threads
        encodes.append(thread_pool.submit(
            codecs.encode_job, np.asarray(img), *eargs))

    def drain_encodes():
        for fut in encodes:
            _settle(fut)
        encodes.clear()
        thread_pool.shutdown(wait=True)
        # the singleton process pool stays alive for the next run

    def flush_bucket(shape, idxs, loaded):
        """Compute one static-shape batch.  A bucket failure keeps going:
        its images fall back to the per-image path (which reports each
        error itself) instead of aborting every other bucket — and in
        multi-host mode an exception here would strand the peers in the
        exit-agreement collective."""
        try:
            bops = ops
            if per_bucket_trace:
                bops = trace_script(script_source,
                                    dims=(shape[1], shape[0]))
            batch = np.stack([loaded.pop(i) for i in idxs])
            out = run_batch(batch, bops)
        except NotVectorizable:
            for i in idxs:
                loaded.pop(i, None)
                if not _run_one_safe(inputs[i], args, fmt, script_source):
                    state["failed"] = True
                else:
                    state["done"] += 1
            return
        except Exception as e:
            print(f"  error: batch of {len(idxs)} {shape[1]}x{shape[0]} "
                  f"images failed ({e}); retrying per-image",
                  file=sys.stderr)
            for i in idxs:
                loaded.pop(i, None)
                if not _run_one_safe(inputs[i], args, fmt, script_source):
                    state["failed"] = True
                else:
                    state["done"] += 1
            return
        for k, i in enumerate(idxs):
            save_one(i, out[k])

    # Layered containers (.pfe/.pdn) need the full canvas path — the flat
    # batch loader can't model script-on-active-layer + composite; the
    # serial runner handles them with identical semantics.
    flat_idxs = []
    for idx, p in enumerate(inputs):
        if pathlib.Path(p).suffix.lower() in (".pfe", ".pdn"):
            if _run_one_safe(inputs[idx], args, fmt, script_source):
                state["done"] += 1
            else:
                state["failed"] = True
        else:
            flat_idxs.append(idx)

    # Stream decode -> bucket -> flush: the decode-ahead window stays
    # bounded (a full-glob drain would hold every decoded image in host
    # memory before the first compute).
    from paintfe_tpu.parallel.prefetch import prefetch_images

    buckets = defaultdict(list)  # (h, w) -> [input index]
    loaded = {}
    for k, (path, img) in enumerate(
            prefetch_images([inputs[i] for i in flat_idxs])):
        idx = flat_idxs[k]
        if isinstance(img, Exception):
            print(f"  error: {img}", file=sys.stderr)
            state["failed"] = True
            continue
        loaded[idx] = img
        shape = img.shape[:2]
        buckets[shape].append(idx)
        if len(buckets[shape]) >= FLUSH_AT:
            flush_bucket(shape, buckets.pop(shape), loaded)
    for shape, idxs in buckets.items():
        flush_bucket(shape, idxs, loaded)
    drain_encodes()

    if args.verbose:
        dt = time.time() - t0
        n = state["done"]
        print(f"sharded batch: {n} images in {dt:.2f}s ({n / max(dt, 1e-9):.1f} img/s)")
    return 1 if state["failed"] else 0


def run_sharded_frames(inputs: List[pathlib.Path], args,
                       script_source: Optional[str]):
    """Frame computation for `--shard --animate` (the BASELINE "1k-image
    sharded batch + per-frame animated export" row): the same bucketed
    mesh engine as run_sharded_batch, but collecting processed frames
    instead of encoding files.  Returns (frames in input order, failed);
    failed inputs are skipped with keep-going semantics, exactly like the
    serial --animate loop."""
    from paintfe_tpu.cli import _INPUT_ERRORS, _compute_frame
    from paintfe_tpu.parallel.prefetch import prefetch_images

    ops = []
    per_bucket_trace = False
    serial_only = False
    if script_source:
        try:
            ops = trace_script(script_source)
        except NotVectorizable as e:
            if str(e) in ("width", "height"):
                per_bucket_trace = True
            else:
                if args.verbose:
                    print(f"note: script uses per-pixel API ({e}); "
                          "running per-image")
                serial_only = True
        except Exception as e:
            print(f"  error: script error: {e}", file=sys.stderr)
            return [], True

    frames = {}
    state = {"failed": False}

    def compute_serial(idx):
        try:
            frames[idx] = _compute_frame(inputs[idx], script_source)
        except _INPUT_ERRORS as e:
            print(f"  error: {e}", file=sys.stderr)
            state["failed"] = True

    if serial_only:
        for idx in range(len(inputs)):
            compute_serial(idx)
        return [frames[i] for i in sorted(frames)], state["failed"]

    def flush_bucket(shape, idxs, loaded):
        try:
            bops = ops
            if per_bucket_trace:
                bops = trace_script(script_source, dims=(shape[1], shape[0]))
            batch = np.stack([loaded.pop(i) for i in idxs])
            out = run_batch(batch, bops)
        except NotVectorizable:
            for i in idxs:
                loaded.pop(i, None)
                compute_serial(i)
            return
        except Exception as e:
            print(f"  error: batch of {len(idxs)} {shape[1]}x{shape[0]} "
                  f"images failed ({e}); retrying per-image",
                  file=sys.stderr)
            for i in idxs:
                loaded.pop(i, None)
                compute_serial(i)
            return
        for k, i in enumerate(idxs):
            frames[i] = np.asarray(out[k])

    # layered containers must go through the full canvas path (script on
    # the active layer + composite), which a flat load_image can't model
    flat, layered = [], []
    for idx, p in enumerate(inputs):
        (layered if pathlib.Path(p).suffix.lower() in (".pfe", ".pdn")
         else flat).append(idx)
    for idx in layered:
        compute_serial(idx)

    buckets = defaultdict(list)
    loaded = {}
    for k, (path, img) in enumerate(
            prefetch_images([inputs[i] for i in flat])):
        idx = flat[k]
        if isinstance(img, Exception):
            print(f"  error: {img}", file=sys.stderr)
            state["failed"] = True
            continue
        loaded[idx] = img
        shape = img.shape[:2]
        buckets[shape].append(idx)
        if len(buckets[shape]) >= FLUSH_AT:
            flush_bucket(shape, buckets.pop(shape), loaded)
    for shape, idxs in buckets.items():
        flush_bucket(shape, idxs, loaded)
    return [frames[i] for i in sorted(frames)], state["failed"]


def _run_one_safe(input_path, args, fmt, script_source) -> bool:
    from paintfe_tpu.cli import build_output_path, run_one

    output_path = build_output_path(input_path, args.output, args.output_dir,
                                    fmt)
    try:
        run_one(
            input_path, output_path, script_source, fmt, args.quality,
            not args.webp_lossy, args.tiff_compression, args.flatten,
            args.verbose,
        )
        return True
    except Exception as e:
        print(f"  error: {e}", file=sys.stderr)
        return False


def _fallback_serial(inputs, args, fmt, script_source) -> int:
    any_failure = False
    for input_path in inputs:
        if not _run_one_safe(input_path, args, fmt, script_source):
            any_failure = True
    return 1 if any_failure else 0
