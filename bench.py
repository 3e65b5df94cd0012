"""Benchmark: the BASELINE headline — 4K blur+adjust+flatten chain.

`python bench.py` prints ONE JSON line: {"metric", "value", "unit",
"ms_per_frame", "device"}, naming the device it ran on; it needs a GPU
and exits non-zero without one.  `--table`, `--scripts`, `--inpaint` and
`--e2e` print the per-op, scripting, inpainting and end-to-end rows.
"""

import functools
import json
import sys
import time

import numpy as np


def _measure(run_k, img_d, ov_d, salt, k_lo, k_hi):
    import jax.numpy as jnp

    def median_of(k, reps=3):
        int(run_k(img_d, ov_d, jnp.uint8(next(salt)), k))
        ts = []
        for _ in range(reps):
            sv = jnp.uint8(next(salt))
            t0 = time.perf_counter()
            int(run_k(img_d, ov_d, sv, k))
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2]

    return (median_of(k_hi) - median_of(k_lo)) / (k_hi - k_lo)


def _rotate_measure(call, make_variant, n=5):
    """Wall-clock median over DISTINCT pre-built inputs (for ops whose
    call path crosses the host, where the in-program k-loop can't apply).
    Consumes a scalar from every result; discards the first call."""
    import jax
    import jax.numpy as jnp

    variants = [make_variant(i) for i in range(n)]
    jax.block_until_ready(variants)
    int(jnp.asarray(call(variants[0])).astype(jnp.uint32).sum())
    ts = []
    for v in variants[1:]:
        t0 = time.perf_counter()
        int(jnp.asarray(call(v)).astype(jnp.uint32).sum())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def table():
    """Per-op numbers at 4K (in-program k-slope: each row times a chain of
    k dependent frames inside one program at two k and takes the slope)."""
    import jax
    import jax.numpy as jnp

    from paintfe_tpu.core.blend import BlendMode, blend_u8
    from paintfe_tpu.ops import filters
    from paintfe_tpu.ops.effects import artistic, contours as contours_mod
    from paintfe_tpu.ops.effects import distort, render
    from paintfe_tpu.ops.fused_chain import fused_chain

    h, w = 2160, 3840
    rng = np.random.default_rng(0)
    img_np = np.asarray(rng.integers(0, 256, (h, w, 4), np.uint8))
    img_d = jax.device_put(img_np)
    ov_d = jax.device_put(np.asarray(rng.integers(0, 256, (h, w, 4), np.uint8)))
    salt = iter(range(10000))

    def row(name, per):
        print(f"{name:26s} {per * 1000:8.2f} ms/4K-frame  "
              f"{h * w / per / 1e9:6.2f} GPix/s")

    def slope_row(name, f, k_lo=5, k_hi=35):
        @functools.partial(jax.jit, static_argnums=3)
        def run_k(img, ov, sv, k, f=f):
            ov = ov.at[0, 0, 0].set(sv)
            out = jax.lax.fori_loop(0, k, lambda i, x: f(img, x), ov)
            return out.astype(jnp.uint32).sum()

        row(name, _measure(run_k, img_d, ov_d, salt, k_lo, k_hi))

    slope_row("headline chain", lambda a, x: fused_chain(a, x))
    slope_row("headline chain sigma=25",
              lambda a, x: fused_chain(a, x, sigma=25.0), k_lo=2, k_hi=10)
    slope_row("blur separable", lambda a, x: filters.gaussian_blur(x, 2.0))
    slope_row("median 3x3 network", lambda a, x: filters.median(x, 1))
    slope_row("blend soft-light",
              lambda a, x: blend_u8(a, x, int(BlendMode.SOFT_LIGHT), 0.6))
    slope_row("bokeh blur r8", lambda a, x: filters.bokeh_blur(x, 8.0),
              k_lo=2, k_hi=10)
    slope_row("zoom blur s0.3x8", lambda a, x: filters.zoom_blur(x))
    slope_row("reduce_noise s30 r2",
              lambda a, x: filters.reduce_noise(x, 30.0, 2), k_lo=2, k_hi=10)
    slope_row("contours s50 f8",
              lambda a, x: contours_mod.contours(x, 50.0, 8.0, 2.0,
                                                 (0, 0, 0, 255)),
              k_lo=2, k_hi=10)
    slope_row("median r4 network", lambda a, x: filters.median(x, 4),
              k_lo=1, k_hi=4)
    slope_row("oil painting r3 l20",
              lambda a, x: artistic.oil_painting(x, 3, 20), k_lo=1, k_hi=4)

    # crystallize's routed accumulator doubles the live set inside a
    # fori_loop (HBM pressure), so it rotates distinct inputs instead.
    def crys_variant(i):
        v = img_np.copy()
        v[0, 0, 0] = i
        return jax.device_put(v)

    row("crystallize 16",
        _rotate_measure(lambda v: distort.crystallize(v, 16.0), crys_variant))

    # Two dents rows: dialog-typical magnitude (±16 px) and extreme
    # scale*amount (±1000 px), both the XLA gather.
    row("dents s8 a2",
        _rotate_measure(lambda v: distort.dents(v, 8.0, 2.0), crys_variant))
    row("dents s50 a20",
        _rotate_measure(lambda v: distort.dents(v, 50.0, 20.0), crys_variant))
    # outline is a pure sync-free device program since the separable-EDT
    # rewrite (no transparency-check round trip), so the k-loop applies
    slope_row("outline w3",
              lambda a, x: render.outline(x, 3.0, (255, 0, 255, 255)))

    # Flood fill / magic wand at 4K: distance map + threshold + scanline
    # reachability as one device program (so the row measures the op, not
    # the image upload).  Two
    # geometries: a simple blob (common case) and a 4K serpentine (the
    # worst case 1-step relaxation needed tens of thousands of sequential
    # steps for).
    from paintfe_tpu.ops import fill

    thr = fill.tolerance_threshold_u8(25.0)

    @functools.partial(jax.jit, static_argnums=(1, 2))
    def wand_device(img, y, x):
        # inlined magic_wand_mask pipeline (the public fn does a host
        # img[y, x] fetch; the bench needs one sync-free device program).
        # Bottleneck semantics: core flood (<= thr) then an AA fringe
        # flood seeded from the core — keep in lockstep with fill.py's
        # magic_wand_mask.
        dist = fill.perceptual_distance_map(img, img[y, x])
        reach_core = fill._reach_loop(
            dist <= thr,
            jnp.zeros(dist.shape, bool).at[y, x].set(True), False)[0]
        fringe = dist <= min(thr + 1, 255)
        reach_fringe = fill._reach_loop(
            fringe, reach_core.at[y, x].set(True) & fringe, False)[0]
        mask = jnp.where(reach_core, 255, jnp.where(reach_fringe, 128, 0))
        return mask.astype(jnp.uint32).sum()

    blob = np.zeros((h, w, 4), np.uint8)
    blob[...] = [30, 30, 30, 255]
    blob[200:1800, 300:3500] = [200, 60, 60, 255]

    def blob_variant(i):
        v = blob.copy()
        v[0, 0, 0] = i
        return jax.device_put(v)

    row("flood fill 4K blob",
        _rotate_measure(lambda v: wand_device(v, 1000, 1000), blob_variant))

    serp = np.zeros((h, w, 4), np.uint8)
    serp[...] = [220, 220, 220, 255]
    for k, y in enumerate(range(16, h - 1, 16)):
        serp[y, :] = [0, 0, 0, 255]
        if k % 2 == 0:
            serp[y, w - 2] = [220, 220, 220, 255]
        else:
            serp[y, 1] = [220, 220, 220, 255]

    def serp_variant(i):
        v = serp.copy()
        v[0, 1, 0] = 219 - i  # salt without changing reachability
        return jax.device_put(v)

    row("flood fill 4K serpentine",
        _rotate_measure(lambda v: wand_device(v, 8, 8), serp_variant, n=4))

    # Warp family (liquify/mesh-warp field): the XLA gather.
    from paintfe_tpu.ops import transform as tfm

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sx_np = (xx - 20 * np.sin(yy / 97.0)).astype(np.float32)
    sy_np = (yy - 20 * np.cos(xx / 131.0)).astype(np.float32)

    # Warp END-TO-END: the public warp_displacement entry from a host-side
    # displacement field (what a Liquify commit pays), incl. the field
    # upload.
    disp_np = np.stack([xx - sx_np, yy - sy_np], axis=-1).astype(np.float32)

    def disp_variant(i):
        v = disp_np.copy()
        v[0, 0, 0] += np.float32(1e-4) * i
        return v  # host array: the e2e path ingests from host

    row("warp e2e warp_displacement",
        _rotate_measure(
            lambda v: jnp.asarray(tfm.warp_displacement(img_np, v)),
            disp_variant))

    # XLA gather row: standard salted in-program k-chain (output feeds the
    # next frame's input; constant displacement field).
    xla_warp = tfm._warp_fn(h, w, h, w)
    disp_d = jax.device_put(disp_np)

    @functools.partial(jax.jit, static_argnums=3)
    def run_warp_k(img, disp, sv, k):
        img = img.at[0, 0, 0].set(sv)
        out = jax.lax.fori_loop(0, k, lambda i, x: xla_warp(x, disp), img)
        return out.astype(jnp.uint32).sum()

    row("warp xla gather", _measure(run_warp_k, img_d, disp_d, salt, 1, 4))

    # Batch pipeline: the traced 4-op script chain vmapped over 64 512x512
    # images (README's batch number).  Salted in-program k-loop over the
    # jitted vmapped chain.
    from paintfe_tpu.parallel.pipeline import PipelineOp, _batch_fn

    ops = (
        PipelineOp("apply_desaturate", ()),
        PipelineOp("apply_brightness_contrast", (10.0, 20.0)),
        PipelineOp("apply_levels", (10.0, 245.0, 1.1)),
        PipelineOp("apply_sepia", (0.5,)),
    )
    chain_fn = _batch_fn(ops)
    batch_np = np.asarray(rng.integers(0, 256, (64, 512, 512, 4), np.uint8))
    batch_d = jax.device_put(batch_np)

    @functools.partial(jax.jit, static_argnums=2)
    def run_batch_k(batch, sv, k):
        batch = batch.at[0, 0, 0, 0].set(sv)
        out = jax.lax.fori_loop(0, k, lambda i, x: chain_fn(x), batch)
        return out.astype(jnp.uint32).sum()

    def _bmed(k, reps=3):
        int(run_batch_k(batch_d, jnp.uint8(next(salt)), k))
        bs = []
        for _ in range(reps):
            sv = jnp.uint8(next(salt))
            t0 = time.perf_counter()
            int(run_batch_k(batch_d, sv, k))
            bs.append(time.perf_counter() - t0)
        bs.sort()
        return bs[len(bs) // 2]

    per = (_bmed(20) - _bmed(5)) / 15
    npx = 64 * 512 * 512
    print(f"{'batch 4-op chain 64x512^2':26s} {per * 1000:8.2f} ms/batch     "
          f"{npx / per / 1e9:6.2f} GPix/s")

    # Spatial chain over the local mesh (halo exchange via ppermute); on
    # one card this just measures the shard_map overhead envelope.
    from paintfe_tpu.parallel.spatial import fused_chain_spatial, rows_mesh

    n_dev = len(jax.local_devices())
    mesh = rows_mesh(jax.local_devices())
    ov_np = np.asarray(jax.device_get(ov_d))

    def spatial_variant(i):
        v = ov_np.copy()
        v[0, 0, 0] = i
        return jax.device_put(v)

    row(f"spatial fused chain ({n_dev}-dev)",
        _rotate_measure(
            lambda v: fused_chain_spatial(img_d, v, mesh), spatial_variant))


def main():
    import jax

    from __graft_entry__ import _chain

    devices = jax.devices()
    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py: JAX finds no GPU; nothing to measure")
    h, w = 2160, 3840  # 4K
    rng = np.random.default_rng(0)
    img_d = jax.device_put(rng.integers(0, 256, (h, w, 4), np.uint8))
    ov_d = jax.device_put(rng.integers(0, 256, (h, w, 4), np.uint8))
    step = jax.jit(_chain())
    jax.block_until_ready(step(img_d, ov_d))  # compile
    ts = []
    for _ in range(50):
        t0 = time.perf_counter()
        jax.block_until_ready(step(img_d, ov_d))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    per_frame = ts[len(ts) // 2]
    print(json.dumps({
        "metric": "4K blur+adjust+flatten chain throughput (one device, "
                  "median of 50 frames)",
        "value": round(h * w / per_frame / 1e9, 3),
        "unit": "GPix/s",
        "ms_per_frame": round(per_frame * 1e3, 4),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": 1},
    }))


def scripts_bench():
    """Scripting-engine tiers, reproducible (host-side, no device needed):
    the tree-walker vs the Python-bytecode transpiler on a 1M-iteration
    arithmetic loop, and the predicated vectorizer on a branchy
    for_each_pixel closure at 1024x1024."""
    import os

    import numpy as np

    from paintfe_tpu.scripting.engine import execute_script_sync

    img = np.zeros((8, 8, 4), np.uint8)
    loop_src = ("let acc = 0; for i in 0..1000000 { acc += i % 7; } "
                "print_line(`${acc}`);")

    def run_once(src, mode, image=img, w=8, h=8):
        prior = os.environ.get("PAINTFE_SCRIPT_COMPILE")
        os.environ["PAINTFE_SCRIPT_COMPILE"] = mode
        try:
            t0 = time.perf_counter()
            out = execute_script_sync(src, image, w, h, None)
            return time.perf_counter() - t0, out[3]
        finally:
            if prior is None:  # restore, don't clobber a user's setting
                os.environ.pop("PAINTFE_SCRIPT_COMPILE", None)
            else:
                os.environ["PAINTFE_SCRIPT_COMPILE"] = prior

    tw, ca = run_once(loop_src, "0")
    tc, cb = run_once(loop_src, "1")
    assert ca == cb
    print(f"rhai 1M-iter loop  tree-walk {tw:6.2f} s ({1e6/tw/1e6:.2f}M it/s)"
          f"   transpiled {tc:6.2f} s ({1e6/tc/1e6:.2f}M it/s)"
          f"   x{tw/tc:.1f}")

    big = np.zeros((1024, 1024, 4), np.uint8)
    big[..., 0] = 128
    big[..., 3] = 255
    # engine arg order is (x, y, r, g, b, a): with r=128 everywhere the
    # branch is data-dependent on the red channel as labeled
    branchy = ("for_each_pixel(|x, y, r, g, b, a| "
               "{ if r > 100 { [255 - r, g, b, a] } else { [r, g, b, a] } });")
    tv, _ = run_once(branchy, "auto", big, 1024, 1024)
    px = 1024 * 1024
    print(f"branchy for_each_pixel 1Mpx (vectorized): {tv:6.2f} s "
          f"({px/tv/1e6:.1f}M px/s)")

    # impure closure (writes captured state) -> per-pixel scalar loop;
    # the closure body itself runs compiled vs tree-walked
    med = np.zeros((192, 192, 4), np.uint8)
    med[..., 0] = 90
    med[..., 3] = 255
    impure = ("let n = 0; for_each_pixel(|x, y, r, g, b, a| "
              "{ if r > 50 { n += 1; } [255 - r, g, b, a] }); "
              "print_line(`${n}`);")
    ti, ca = run_once(impure, "0", med.copy(), 192, 192)
    tc2, cb2 = run_once(impure, "auto", med.copy(), 192, 192)
    assert ca == cb2
    ppx = 192 * 192
    print(f"impure for_each_pixel (scalar loop)  tree-walk "
          f"{ppx/ti/1e3:5.0f}k px/s   closure-compiled "
          f"{ppx/tc2/1e3:5.0f}k px/s   x{ti/tc2:.1f}")


def inpaint_bench():
    """Content-aware fill latency vs the reference's published tiers
    (src/ops/inpaint.rs:13-15: balanced ~0.5-2 s, high-quality ~3-10 s on
    an unspecified CPU).  1024x768 canvas, 120x160 hole, native
    PatchMatch (native/inpaint.cpp)."""
    import numpy as np

    from paintfe_tpu.ops import inpaint

    rng = np.random.default_rng(0)
    h, w = 768, 1024
    src = rng.integers(0, 256, (h, w, 4), np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[300:420, 400:560] = 255
    for tier, (ps, it), ref in (("balanced", (5, 3), "0.5-2 s"),
                                ("high_quality", (7, 6), "3-10 s")):
        t0 = time.perf_counter()
        inpaint.fill_region_patchmatch(src, mask, ps, it)
        dt = time.perf_counter() - t0
        print(f"inpaint {tier:13s} {dt:5.2f} s   (reference claim: {ref})")


def e2e_bench():
    """Honest end-to-end headless-pipeline throughput — the SURVEY north
    star (decode -> Rhai script -> encode), measured at the CLI surface
    through the sharded batch runner with the prefetch loader overlapping
    host IO against device compute.

    The first (warm-up) run eats compiles and the page cache; the
    reported number is the median of 3 subsequent full-batch runs.  The
    attribution rows time each stage alone on the same data so the
    binding constraint is explicit.
    """
    import pathlib
    import shutil
    import statistics
    import tempfile

    from paintfe_tpu import cli
    from paintfe_tpu.io import codecs
    from paintfe_tpu.parallel.pipeline import run_batch, trace_script

    rng = np.random.default_rng(0)
    script_src = ("apply_blur(2.0);\n"
                  "apply_brightness_contrast(10.0, 20.0);\n"
                  "apply_levels(10.0, 245.0, 1.1);\n"
                  "apply_sepia(0.5);\n")

    for label, h, w, n in (("1 Mpix", 1024, 1024, 24),
                           ("4 Mpix", 2048, 2048, 12)):
        tmp = pathlib.Path(tempfile.mkdtemp(prefix="pfe_e2e_"))
        try:
            for i in range(n):
                img = rng.integers(0, 256, (h, w, 4), np.uint8)
                codecs.save_image(img, tmp / f"i{i:03d}.png", "png")
            script = tmp / "s.rhai"
            script.write_text(script_src)

            def run_once(tag):
                out = tmp / f"out_{tag}"
                out.mkdir()
                t0 = time.perf_counter()
                rc = cli.main(["-i", str(tmp / "i*.png"), "-s", str(script),
                               "--shard", "--output-dir", str(out),
                               "-f", "png"])
                dt = time.perf_counter() - t0
                assert rc == 0
                shutil.rmtree(out)
                return dt

            run_once("warm")  # compiles + page cache
            dts = [run_once(f"t{j}") for j in range(3)]
            dt = statistics.median(dts)

            # attribution on the same inputs: decode-only, compute-only
            # (device incl. transfers), encode-only
            t0 = time.perf_counter()
            imgs = [codecs.load_image(tmp / f"i{i:03d}.png")
                    for i in range(n)]
            t_dec = time.perf_counter() - t0
            ops = trace_script(script_src)
            batch = np.stack(imgs)
            run_batch(batch, ops)  # warm
            t0 = time.perf_counter()
            outs = run_batch(batch, ops)
            t_dev = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(n):
                codecs.save_image(outs[i], tmp / f"enc{i:03d}.png", "png")
            t_enc = time.perf_counter() - t0

            print(f"e2e {label}: {n} images in {dt:.2f} s "
                  f"({n / dt:.2f} img/s, {n * h * w / dt / 1e6:.0f} MPix/s) "
                  f"[runs {', '.join(f'{d:.2f}' for d in dts)}]")
            print(f"    attribution: decode {t_dec:.2f} s, device "
                  f"compute+transfers {t_dev:.2f} s, encode {t_enc:.2f} s "
                  f"(host codecs {'bind' if t_dec + t_enc > t_dev else 'do not bind'})")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    if "--table" in sys.argv:
        table()
    elif "--scripts" in sys.argv:
        scripts_bench()
    elif "--inpaint" in sys.argv:
        inpaint_bench()
    elif "--e2e" in sys.argv:
        e2e_bench()
    else:
        main()
