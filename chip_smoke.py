"""On-card smoke run of the headless pipeline, checked against the CPU path.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the multi-card paths only

One process drives the card(s); the reference is the same code on
jax.devices("cpu") in that process, with XLA:CPU pinned to SSE4_2 as the
test suite pins it (no FMA contraction), which is the path certified
against the reference's goldens.  Every phase prints its wall time and
its parity (largest |difference| in u8 levels and how many values differ,
against a stated tolerance); any failure ends the run with a non-zero
exit.  The last line of standard output is one JSON object naming the
device JAX ran on.

Phases on one card:
  numerics   f32 divide is correctly rounded, mul+add is not contracted
  ops        the main path's ops, at 4K on the card (time and byte floor)
             and against the CPU at 3840 px wide
  headline   the BASELINE chain at 4K: ms per frame, XLA fusion count
  cli-shard  `cli --shard` over a batch of 4K PNGs (traced op chain)
  cli-serial `cli` on a 4K PNG with a for_each_pixel closure
  pfe        an 8-layer 4K .pfe in mixed blend modes, flattened by the CLI
  server     serve_tcp answering jobs
  bench      bench.py main()
With --four-cards: `cli --shard` on 4 cards byte-compared with a 1-card
mesh, and an 8K canvas through fused_chain_spatial on 4 cards compared
with one card.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FRAME_4K = (2160, 3840)


class SmokeFailure(Exception):
    pass


def _setup_env():
    """Before JAX starts: the CPU reference's pinned ISA, and a CPU
    backend beside the GPU one."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_max_isa" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_max_isa=SSE4_2").strip()
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"


@contextlib.contextmanager
def phase(name):
    print(f"[{name}]", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def check(name, got, want, tol):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SmokeFailure(f"{name}: {got.shape} {got.dtype} vs "
                           f"{want.shape} {want.dtype}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    mx, n = int(d.max(initial=0)), int((d > 0).sum())
    print(f"  parity {name}: max |diff| {mx}, {n} of {d.size} differ "
          f"(tolerance {tol})", flush=True)
    if mx > tol:
        raise SmokeFailure(f"{name}: max |diff| {mx} > {tol}")


def time_on_card(fn, *args, reps=20):
    """(output, median seconds) over `reps` calls after a warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return out, ts[len(ts) // 2]


def frames(seed, n, h, w):
    """n RGBA u8 frames: smooth gradients plus noise, opaque-ish alpha."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for k in range(n):
        base = np.stack([(xx * 255 // w + 40 * k) % 256,
                         (yy * 255 // h + 17 * k) % 256,
                         ((xx + yy) // 7 + 5 * k) % 256,
                         np.full_like(xx, 255 - 9 * k)], -1)
        noise = rng.integers(-12, 13, (h, w, 4))
        out.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return out


def on_cpu(fn, *args):
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.device_get(fn(*(jax.device_put(a, cpu) for a in args)))


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_numerics(gpu):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from paintfe_tpu.utils.quant import exact_div

    x = np.arange(256, dtype=np.float32)
    got = np.asarray(jax.jit(lambda v: exact_div(v, 255.0))(jax.device_put(x, gpu)))
    bad = int((got != x / np.float32(255.0)).sum())
    a = np.repeat(x, 255)
    b = np.tile(np.arange(1, 256, dtype=np.float32), 256)
    q = np.asarray(jax.jit(jnp.divide)(jax.device_put(a, gpu), jax.device_put(b, gpu)))
    bad2 = int((q != a / b).sum())
    s = np.asarray(jax.jit(jnp.sqrt)(jax.device_put(x / 255, gpu)))
    bad3 = int((s != np.sqrt(x / 255)).sum())
    rng = np.random.default_rng(0)
    m1, m2, m3 = (rng.random(1 << 20, dtype=np.float32) * 255 for _ in range(3))
    fma = np.asarray(jax.jit(lambda p, q, r: p * q + r)(
        *(jax.device_put(v, gpu) for v in (m1, m2, m3))))
    contracted = int((fma != m1 * m2 + m3).sum())
    print(f"  u8/255 quotients not correctly rounded: {bad} of 256; u8/u8: "
          f"{bad2} of {a.size}; sqrt(u8/255): {bad3} of 256; mul+add "
          f"differing from separate rounding: {contracted} of {m1.size}")
    if bad or bad2 or bad3 or contracted:
        raise SmokeFailure("GPU f32 math is not IEEE: are the NVPTX options "
                           "of paintfe_tpu/__init__.py in XLA_FLAGS?")


def _op_table():
    from paintfe_tpu.core.blend import BlendMode, blend_u8
    from paintfe_tpu.core.composite import composite_stack_static
    from paintfe_tpu.ops import adjustments as adj
    from paintfe_tpu.ops import filters
    from paintfe_tpu.ops import transform as tfm
    from paintfe_tpu.ops.effects import distort, stylize
    from paintfe_tpu.ops.effects import noise as noise_mod
    from paintfe_tpu.parallel.pipeline import _bc_device, _sepia_device

    curve = [(((0.0, 0.0), (64.0, 40.0), (192.0, 220.0), (255.0, 255.0)), True)] \
        + [(((0.0, 0.0), (255.0, 255.0)), False)] * 4
    modes = (0, 1, 2, 3, 8, 12, 16, 21)
    opac = [0.3 + 0.1 * k for k in range(8)]

    def warp(img, field):
        return tfm.warp_displacement(img, field)

    def layers8(img, ov, _field):
        import jax.numpy as jnp

        stack = jnp.stack([img, ov, img[::-1], ov[::-1], img[:, ::-1],
                           ov[:, ::-1], 255 - img, 255 - ov])
        return composite_stack_static(stack, modes, opac)

    # (name, fn(img, ov, field), tolerance, frames read + written)
    return [
        ("gaussian_blur s=2", lambda a, o, f: filters.gaussian_blur(a, 2.0), 0, 2),
        ("median r=1", lambda a, o, f: filters.median(a, 1), 0, 2),
        ("median r=2", lambda a, o, f: filters.median(a, 2), 0, 2),
        ("median r=4", lambda a, o, f: filters.median(a, 4), 0, 2),
        ("warp_displacement", lambda a, o, f: warp(a, f), 0, 4),
        ("dents s8 a2 (gentle)", lambda a, o, f: distort.dents(a, 8.0, 2.0), 0, 2),
        ("dents s50 a20 (extreme)", lambda a, o, f: distort.dents(a, 50.0, 20.0), 0, 2),
        ("twist 45", lambda a, o, f: distort.twist(a, 45.0), 1, 2),
        ("levels (LUT)", lambda a, o, f: adj.levels(a, 10.0, 245.0, 1.1, 0.0, 255.0), 0, 2),
        ("curves (LUT)", lambda a, o, f: adj.curves(a, curve), 0, 2),
        ("brightness/contrast", lambda a, o, f: _bc_device(a, 10.0, 20.0), 0, 2),
        ("sepia", lambda a, o, f: _sepia_device(a, 0.5), 0, 2),
        ("hue/sat/lightness", lambda a, o, f: adj.hue_saturation_lightness(a, 30.0, 20.0, -10.0), 1, 2),
        ("vignette", lambda a, o, f: stylize.vignette(a, 0.6, 0.5), 1, 2),
        ("noise gaussian", lambda a, o, f: noise_mod.add_noise(
            a, 20.0, noise_mod.NoiseType.GAUSSIAN, False, 42, 1.0, 1), 1, 2),
        ("blend soft-light 0.6", lambda a, o, f: blend_u8(a, o, int(BlendMode.SOFT_LIGHT), 0.6), 0, 3),
        ("blend color-dodge 0.8", lambda a, o, f: blend_u8(a, o, int(BlendMode.COLOR_DODGE), 0.8), 0, 3),
        ("composite 8 layers", layers8, 0, 3),
    ]


def _field(h, w):
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([20 * np.sin(yy / 97.0), 20 * np.cos(xx / 131.0)],
                    -1).astype(np.float32)


def phase_ops(gpu, kind):
    import jax

    h, w = FRAME_4K
    img, ov = frames(1, 2, h, w)
    field = _field(h, w)
    strip = 272
    args_gpu = [jax.device_put(v, gpu) for v in (img, ov, field)]
    args_strip = (img[:strip], ov[:strip], field[:strip])
    frame_bytes = h * w * 4
    for name, fn, tol, nframes in _op_table():
        jf = jax.jit(fn)
        t0 = time.perf_counter()
        _, sec = time_on_card(jf, *args_gpu, reps=10)
        floor = nframes * frame_bytes / HBM_BYTES_PER_S
        print(f"  {name}: {sec * 1e3:.3f} ms per 4K frame on {kind} "
              f"(byte floor {floor * 1e6:.0f} us; first call + 10 runs "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
        got = jax.device_get(jf(*(jax.device_put(v, gpu) for v in args_strip)))
        check(f"{name} @ {got.shape[0]}x{w}", got,
              on_cpu(jax.jit(fn), *args_strip), tol)


def phase_headline(gpu, kind):
    import re

    import jax

    from __graft_entry__ import _chain, entry

    step, example = entry()
    jax.block_until_ready(jax.jit(step)(*example))
    h, w = FRAME_4K
    img, ov = frames(2, 2, h, w)
    img_g, ov_g = jax.device_put(img, gpu), jax.device_put(ov, gpu)
    chain = jax.jit(_chain())
    hlo = chain.lower(img_g, ov_g).compile().as_text()
    fusions = len(re.findall(r"^\s*(?:ROOT )?\S+ = \S+ fusion\(", hlo, re.M))
    _, sec = time_on_card(chain, img_g, ov_g, reps=30)
    floor = 3 * h * w * 4 / HBM_BYTES_PER_S
    print(f"  headline chain: {sec * 1e3:.3f} ms per 4K frame on {kind} "
          f"({h * w / sec / 1e9:.2f} GPix/s; byte floor {floor * 1e6:.0f} us; "
          f"{fusions} XLA fusions)", flush=True)
    strip = 272
    got = jax.device_get(chain(jax.device_put(img[:strip], gpu),
                               jax.device_put(ov[:strip], gpu)))
    # levels' pow comes from libdevice on the card: at most 1 u8 apart
    check(f"headline @ {got.shape[0]}x{w}", got,
          on_cpu(jax.jit(_chain()), img[:strip], ov[:strip]), 1)


CHAIN_SCRIPT = ("apply_blur(2.0);\n"
                "apply_brightness_contrast(10.0, 20.0);\n"
                "apply_levels(10.0, 245.0, 1.1);\n"
                "apply_sepia(0.5);\n")


def _write_batch(d, n, seed):
    from paintfe_tpu.io import codecs

    paths = []
    for k, img in enumerate(frames(seed, n, *FRAME_4K)):
        p = d / f"frame{k:02d}.png"
        codecs.save_image(img, p, "png")
        paths.append(p)
    return paths


def _chain_reference(img):
    import jax

    from paintfe_tpu.parallel.pipeline import compile_pipeline, trace_script

    return on_cpu(jax.jit(compile_pipeline(trace_script(CHAIN_SCRIPT))), img)


def _workers_without_jax():
    """True when no encode-pool worker process has a JAX backend."""
    from paintfe_tpu.parallel import batch

    pool = batch._PROC_POOL
    if pool is None:
        raise SmokeFailure("the batch never started its encode workers")
    probe = ("'jax' not in __import__('sys').modules or not "
             "__import__('jax._src.xla_bridge', fromlist=['_backends'])._backends")
    return all(pool.submit(eval, probe).result(timeout=60) for _ in range(8))


def phase_cli_shard(tmp):
    from paintfe_tpu import cli
    from paintfe_tpu.io import codecs

    d = tmp / "shard"
    d.mkdir()
    paths = _write_batch(d, 8, seed=3)
    (d / "chain.rhai").write_text(CHAIN_SCRIPT)
    out = d / "out"
    t0 = time.perf_counter()
    rc = cli.main(["-i", str(d / "frame*.png"), "-s", str(d / "chain.rhai"),
                   "--shard", "--output-dir", str(out), "-f", "png"])
    dt = time.perf_counter() - t0
    print(f"  cli --shard: {len(paths)} 4K PNGs in {dt:.2f} s "
          f"({len(paths) / dt:.2f} img/s, decode+device+encode)", flush=True)
    if rc != 0:
        raise SmokeFailure(f"cli --shard exited {rc}")
    for p in paths[:2]:
        check(f"cli --shard {p.name}", codecs.load_image(out / p.name),
              _chain_reference(codecs.load_image(p)), 1)
    if not _workers_without_jax():
        raise SmokeFailure("an encode worker initialised a JAX backend")
    print("  encode workers: no JAX backend in any of them")


def phase_cli_serial(tmp):
    import numpy as np

    from paintfe_tpu import cli
    from paintfe_tpu.io import codecs

    d = tmp / "serial"
    d.mkdir()
    (src,) = _write_batch(d, 1, seed=5)
    script = d / "px.rhai"
    script.write_text("for_each_pixel(|x, y, r, g, b, a| { if r > 100 "
                      "{ [255 - r, g, b, a] } else { [r, g, b, a] } });\n")
    out = d / "out.png"
    t0 = time.perf_counter()
    rc = cli.main(["-i", str(src), "-s", str(script), "-o", str(out)])
    print(f"  cli for_each_pixel on one 4K PNG: {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise SmokeFailure(f"cli exited {rc}")
    img = codecs.load_image(src)
    want = img.copy()
    hot = img[..., 0] > 100
    want[..., 0] = np.where(hot, 255 - img[..., 0], img[..., 0])
    check("cli for_each_pixel", codecs.load_image(out), want, 0)


def phase_pfe(tmp):
    from paintfe_tpu import cli
    from paintfe_tpu.core.blend import BlendMode
    from paintfe_tpu.core.canvas import Canvas, Layer
    from paintfe_tpu.io import codecs, pfe

    h, w = FRAME_4K
    modes = [BlendMode.NORMAL, BlendMode.MULTIPLY, BlendMode.SCREEN,
             BlendMode.OVERLAY, BlendMode.SOFT_LIGHT, BlendMode.COLOR_DODGE,
             BlendMode.DIFFERENCE, BlendMode.HARD_MIX, BlendMode.LINEAR_LIGHT]
    canvas = Canvas.new(w, h)
    canvas.layers = []
    for k, (px, mode) in enumerate(zip(frames(7, len(modes), h, w), modes)):
        layer = Layer.new(f"L{k}", w, h)
        layer.pixels = px
        layer.blend_mode = mode
        layer.opacity = 1.0 if k == 0 else 0.35 + 0.07 * k
        canvas.layers.append(layer)
    doc = tmp / "doc.pfe"
    pfe.save_pfe(canvas, str(doc))
    out = tmp / "doc.png"
    t0 = time.perf_counter()
    rc = cli.main(["-i", str(doc), "-o", str(out)])
    print(f"  cli flatten of a {len(modes)}-layer 4K .pfe: "
          f"{time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise SmokeFailure(f"cli exited {rc}")
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        want = pfe.load_pfe(str(doc)).composite()
    check("pfe flatten", codecs.load_image(out), want, 0)


def phase_server(tmp):
    from paintfe_tpu import server
    from paintfe_tpu.io import codecs

    d = tmp / "server"
    d.mkdir()
    paths = _write_batch(d, 3, seed=9)
    (d / "chain.rhai").write_text(CHAIN_SCRIPT)
    srv, port = server.serve_tcp("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        for p in paths:
            reply = server.request(port, {"input": str(p),
                                          "output": str(d / f"o_{p.name}"),
                                          "script": str(d / "chain.rhai")},
                                   timeout=600)
            print(f"  job {p.name}: {reply}", flush=True)
            if not reply.get("ok"):
                raise SmokeFailure(f"server job failed: {reply}")
        ping = server.request(port, {"cmd": "ping"})
        if ping.get("jobs_done") != len(paths):
            raise SmokeFailure(f"server ping: {ping}")
        server.request(port, {"cmd": "shutdown"})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    check("server job", codecs.load_image(d / f"o_{paths[0].name}"),
          _chain_reference(codecs.load_image(paths[0])), 1)


def phase_bench():
    import bench

    bench.main()


def run_one_card(gpu, kind):
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as td:
        tmp = pathlib.Path(td)
        with phase("numerics"):
            phase_numerics(gpu)
        with phase("ops"):
            phase_ops(gpu, kind)
        with phase("headline"):
            phase_headline(gpu, kind)
        with phase("cli-shard"):
            phase_cli_shard(tmp)
        with phase("cli-serial"):
            phase_cli_serial(tmp)
        with phase("pfe"):
            phase_pfe(tmp)
        with phase("server"):
            phase_server(tmp)
        with phase("bench"):
            phase_bench()


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def run_four_cards(gpus, kind):
    import jax
    import numpy as np

    from paintfe_tpu import cli
    from paintfe_tpu.io import codecs
    from paintfe_tpu.ops.fused_chain import fused_chain
    from paintfe_tpu.parallel import spatial
    from paintfe_tpu.parallel.mesh import batch_mesh
    from paintfe_tpu.parallel.pipeline import run_batch, trace_script

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as td:
        tmp = pathlib.Path(td)
        with phase("cli-shard on 4 cards"):
            paths = _write_batch(tmp, 8, seed=11)
            (tmp / "chain.rhai").write_text(CHAIN_SCRIPT)
            out = tmp / "out"
            t0 = time.perf_counter()
            rc = cli.main(["-i", str(tmp / "frame*.png"), "-s",
                           str(tmp / "chain.rhai"), "--shard",
                           "--output-dir", str(out), "-f", "png"])
            dt = time.perf_counter() - t0
            print(f"  cli --shard over {len(gpus)} cards: {len(paths)} 4K "
                  f"PNGs in {dt:.2f} s", flush=True)
            if rc != 0:
                raise SmokeFailure(f"cli --shard exited {rc}")
            batch = np.stack([codecs.load_image(p) for p in paths])
            one = run_batch(batch, trace_script(CHAIN_SCRIPT),
                            mesh=batch_mesh(gpus[:1]))
            for k, p in enumerate(paths):
                ref = tmp / f"one_{p.name}"
                codecs.save_image(one[k], ref, "png")
                if ref.read_bytes() != (out / p.name).read_bytes():
                    raise SmokeFailure(f"{p.name}: 4-card bytes differ "
                                       "from the 1-card mesh")
            print(f"  all {len(paths)} outputs byte-equal to the 1-card mesh")
        with phase("8K spatial chain on 4 cards"):
            h, w = 4320, 7680
            img, ov = frames(13, 2, h, w)
            mesh = spatial.rows_mesh(gpus)
            run = lambda: spatial.fused_chain_spatial(img, ov, mesh)  # noqa: E731
            got, sec = time_on_card(run, reps=5)
            print(f"  fused_chain_spatial 8K over {len(gpus)} cards: "
                  f"{sec * 1e3:.2f} ms per frame incl. host transfers ({kind})")
            single = jax.jit(fused_chain)
            want, sec1 = time_on_card(
                single, jax.device_put(img, gpus[0]),
                jax.device_put(ov, gpus[0]), reps=5)
            print(f"  fused_chain 8K on one card: {sec1 * 1e3:.2f} ms per "
                  f"frame (inputs resident)")
            check("8K spatial vs one card", jax.device_get(got),
                  jax.device_get(want), 0)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    sys.path.insert(0, str(REPO))
    _setup_env()
    try:
        import paintfe_tpu  # noqa: F401  (sets the GPU math flags first)
    except ImportError:
        print("chip_smoke: the paintfe_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus or jax.default_backend() != "gpu":
        print("chip_smoke: JAX finds no GPU; this check runs on the card "
              "only", file=sys.stderr)
        return 1
    if four and len(gpus) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(gpus)}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    from paintfe_tpu import native
    from paintfe_tpu.utils.compile_cache import enable_persistent_cache

    print(f"jax {jax.__version__}; devices {gpus}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}")
    print(f"compile cache: {enable_persistent_cache()}")
    print(f"native host library: "
          f"{'built' if native.load() is not None else 'unavailable'}",
          flush=True)
    kind = gpus[0].device_kind
    try:
        if four:
            run_four_cards(gpus[:4], kind)
        else:
            run_one_card(gpus[0], kind)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        from paintfe_tpu.parallel import batch

        if batch._PROC_POOL is not None:
            batch._PROC_POOL.shutdown(wait=True, cancel_futures=True)
    print(json.dumps({"ok": True, "device": {
        "platform": gpus[0].platform, "kind": kind,
        "count": 4 if four else 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
