"""Property/fuzz tests: container round-trips, parser resilience, engine
limits.  Complements the golden suite with randomized coverage."""

import numpy as np
import pytest

from paintfe_tpu.core.blend import BlendMode
from paintfe_tpu.core.canvas import Canvas, Layer
from paintfe_tpu.scripting import ScriptError, execute_script_sync


def test_pfe_roundtrip_fuzz(tmp_path):
    from paintfe_tpu.io import pfe

    rng = np.random.default_rng(11)
    for trial in range(5):
        w, h = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        n_layers = int(rng.integers(1, 5))
        c = Canvas.new(w, h)
        c.layers = []
        for i in range(n_layers):
            layer = Layer.new(f"L{i}", w, h)
            layer.pixels = rng.integers(0, 256, (h, w, 4), np.uint8)
            layer.opacity = float(rng.random())
            layer.blend_mode = BlendMode(int(rng.integers(0, 25)))
            layer.visible = bool(rng.integers(0, 2))
            c.layers.append(layer)
        path = tmp_path / f"fuzz_{trial}.pfe"
        pfe.save_pfe(c, str(path))
        back = pfe.load_pfe(str(path))
        assert (back.width, back.height) == (w, h)
        assert len(back.layers) == n_layers
        for a, b in zip(c.layers, back.layers):
            np.testing.assert_array_equal(np.asarray(a.pixels), np.asarray(b.pixels))
            assert a.blend_mode == b.blend_mode and a.visible == b.visible
            assert abs(a.opacity - b.opacity) < 1e-6


def test_nrbf_truncated_streams_error_cleanly():
    import struct as _st

    from paintfe_tpu.io.nrbf import NrbfError, NrbfReader

    def lp(s):
        b = s.encode()
        return bytes([len(b)]) + b

    # a layer-list-shaped stream: one library, then three classes whose
    # String members each hold a BinaryObjectString record
    body = b"\x00" + _st.pack("<iiii", 1, -1, 1, 0) + b"\x0c" + _st.pack(
        "<i", 1) + lp("PaintDotNet.Data")
    for k, name in enumerate(("Document", "LayerList", "BitmapLayer")):
        body += (b"\x05" + _st.pack("<i", k + 1) + lp(name)
                 + _st.pack("<i", 2) + lp("name") + lp("blendMode")
                 + b"\x01\x01" + _st.pack("<i", 1)
                 + _nrbf_prim_string(100 + 2 * k, f"{name} layer title")
                 + _nrbf_prim_string(101 + 2 * k, "Normal"))
    body += b"\x0b"
    body_off = 7
    good = b"PDN3" + bytes([0, 0, 0]) + body
    full = NrbfReader(good, body_off).parse()
    assert full.end_pos == len(good)
    assert full.find_instances("BitmapLayer")[0].get("blendMode") == "Normal"
    # every truncation point must raise NrbfError/ValueError, never hang/crash
    for cut in (body_off + 3, body_off + 50, full.end_pos - 10):
        with pytest.raises((NrbfError, ValueError, IndexError)):
            NrbfReader(good[:cut], body_off).parse()


def test_pdn_garbage_bodies_rejected(tmp_path):
    from paintfe_tpu.io.pdn import PdnError, load_pdn

    rng = np.random.default_rng(3)
    for trial in range(3):
        blob = b"PDN3" + bytes([8, 0, 0]) + b"<a></a>\x00" + rng.bytes(200)
        p = tmp_path / f"junk{trial}.pdn"
        p.write_bytes(blob)
        with pytest.raises(PdnError):
            load_pdn(p)


def test_script_operation_budget_enforced():
    img = np.zeros((4, 4, 4), np.uint8)
    from paintfe_tpu.scripting.engine import compile_script
    from paintfe_tpu.scripting.api import ScriptContext, build_host_fns
    from paintfe_tpu.scripting.interp import Interpreter, RhaiRuntimeError

    ctx = ScriptContext(img, 4, 4, None, rng_seed=0)
    ref = {}
    interp = Interpreter(build_host_fns(ctx, ref), max_operations=10_000)
    ref["interp"] = interp
    with pytest.raises(RhaiRuntimeError, match="operation limit"):
        interp.run("let i = 0; while true { i += 1; }")


def test_script_recursion_depth_limited():
    with pytest.raises(ScriptError):
        execute_script_sync(
            "fn f(n) { f(n + 1) } f(0);",
            np.zeros((4, 4, 4), np.uint8), 4, 4,
        )


def test_deep_export_tiff_reader_rejects_garbage(tmp_path):
    from paintfe_tpu.io.deep_export import read_tiff_deep

    p = tmp_path / "junk.tiff"
    p.write_bytes(b"definitely not a tiff")
    with pytest.raises(ValueError):
        read_tiff_deep(p)


def test_blend_u8_property_alpha_zero_and_opaque_normal():
    """Property over all modes: transparent top == identity; Normal opaque
    top at full opacity == top."""
    import jax

    from paintfe_tpu.core.blend import blend_u8

    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (16, 16, 4), np.uint8)
    top = rng.integers(0, 256, (16, 16, 4), np.uint8)
    clear = top.copy()
    clear[..., 3] = 0
    for mode in range(25):
        out = np.asarray(jax.jit(
            lambda b, t, m=mode: blend_u8(b, t, m, 1.0)
        )(base, clear))
        np.testing.assert_array_equal(out, base, err_msg=f"mode {mode}")
    opaque = top.copy()
    opaque[..., 3] = 255
    out = np.asarray(jax.jit(lambda b, t: blend_u8(b, t, 0, 1.0))(base, opaque))
    np.testing.assert_array_equal(out, opaque)


def _nrbf_prim_string(object_id: int, s: str) -> bytes:
    import struct as _st

    b = s.encode()
    assert len(b) < 128
    return b"\x06" + _st.pack("<i", object_id) + bytes([len(b)]) + b


def test_nrbf_binarylibrary_in_member_slot():
    """MS-NRBF: memberReference = BinaryLibrary? + value — the formatter
    emits a library record before the first class of each NEW assembly,
    which can land mid-member.  Treating the library as the value desynced
    the stream (r4 review, repro-confirmed)."""
    import struct as _st

    from paintfe_tpu.io.nrbf import NrbfReader

    def lp(s):
        b = s.encode()
        return bytes([len(b)]) + b

    stream = (
        b"\x00" + _st.pack("<iiii", 1, -1, 1, 0)          # header, root=1
        + b"\x0c" + _st.pack("<i", 1) + lp("Lib1")        # library id 1
        # ClassWithMembersAndTypes id=1, 1 member 'a', bin type Object(2)
        + b"\x05" + _st.pack("<i", 1) + lp("C") + _st.pack("<i", 1)
        + lp("a") + b"\x02" + _st.pack("<i", 1)            # library id 1
        # member slot: BinaryLibrary(id=2) THEN the actual value (a string)
        + b"\x0c" + _st.pack("<i", 2) + lp("Lib2")
        + _nrbf_prim_string(7, "hello")
        + b"\x0b"                                          # MessageEnd
    )
    reader = NrbfReader(stream, 0).parse()
    objs = reader.find_instances("C")
    assert objs and objs[0].get("a") == "hello"


def test_nrbf_null_multiple_zero_rejected():
    """ObjectNullMultiple with count 0 left pending=-1 (truthy) and nulled
    every remaining slot instead of erroring (r4 review)."""
    import struct as _st

    from paintfe_tpu.io.nrbf import NrbfError, NrbfReader

    def lp(s):
        b = s.encode()
        return bytes([len(b)]) + b

    stream = (
        b"\x00" + _st.pack("<iiii", 1, -1, 1, 0)
        + b"\x0c" + _st.pack("<i", 1) + lp("L")
        + b"\x05" + _st.pack("<i", 1) + lp("C") + _st.pack("<i", 2)
        + lp("a") + lp("b") + b"\x02\x02" + _st.pack("<i", 1)
        + b"\x0d\x00"                                      # NullMultiple256, 0
        + _nrbf_prim_string(7, "x")
        + b"\x0b"
    )
    import pytest as _pytest

    with _pytest.raises(NrbfError, match="count <= 0"):
        NrbfReader(stream, 0).parse()
