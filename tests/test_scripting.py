"""Script engine end-to-end tests (mirror of tests/scripting.rs)."""

import numpy as np
import pytest

from paintfe_tpu.core import fixtures
from paintfe_tpu.ops import adjustments as adj
from paintfe_tpu.scripting import ScriptError, execute_script_sync

from common import assert_golden


def run_script(source):
    img = fixtures.test_gradient(64, 64)
    out, w, h, console, _ops = execute_script_sync(source, img, 64, 64, None)
    return np.asarray(out).reshape(h, w, 4), console


def test_width_height():
    _, console = run_script(
        """
        let w = width();
        let h = height();
        print_line(`${w}x${h}`);
        """
    )
    assert console[-1] == "64x64"


def test_set_pixel():
    result, _ = run_script(
        """
        set_pixel(0, 0, 255, 0, 0, 255);
        set_pixel(1, 0, 0, 255, 0, 128);
        """
    )
    np.testing.assert_array_equal(result[0, 0], [255, 0, 0, 255])
    np.testing.assert_array_equal(result[0, 1], [0, 255, 0, 128])


def test_get_pixel_roundtrip():
    result, _ = run_script(
        """
        let r = get_r(0, 0);
        let g = get_g(0, 0);
        let b = get_b(0, 0);
        let a = get_a(0, 0);
        set_pixel(1, 1, r, g, b, a);
        """
    )
    orig = fixtures.test_gradient(64, 64)[0, 0]
    np.testing.assert_array_equal(result[1, 1], orig)


def test_for_each_pixel_invert():
    result, _ = run_script(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            [255 - r, 255 - g, 255 - b, a]
        });
        """
    )
    assert_golden("scripting", "for_each_pixel_invert", result)


def test_map_channels_invert():
    result, _ = run_script(
        """
        map_channels(|r, g, b, a| {
            [255 - r, 255 - g, 255 - b, a]
        });
        """
    )
    assert_golden("scripting", "map_channels_invert", result)


def test_apply_blur():
    result, _ = run_script("apply_blur(2.0);")
    assert_golden("scripting", "apply_blur", result)


def test_apply_invert():
    result, _ = run_script("apply_invert();")
    assert_golden("scripting", "apply_invert", result)


def test_apply_sepia():
    result, _ = run_script("apply_sepia();")
    assert_golden("scripting", "apply_sepia", result)


def test_apply_desaturate():
    result, _ = run_script("apply_desaturate();")
    assert_golden("scripting", "apply_desaturate", result)


def test_apply_brightness_contrast():
    result, _ = run_script("apply_brightness_contrast(20.0, 10.0);")
    assert_golden("scripting", "apply_brightness_contrast", result)


def test_apply_pixelate():
    result, _ = run_script("apply_pixelate(4);")
    assert_golden("scripting", "apply_pixelate", result)


def test_flip_horizontal():
    result, _ = run_script("flip_horizontal();")
    assert_golden("scripting", "flip_horizontal", result)


def test_flip_vertical():
    result, _ = run_script("flip_vertical();")
    assert_golden("scripting", "flip_vertical", result)


def test_flip_roundtrip():
    result, _ = run_script("flip_horizontal();\nflip_horizontal();")
    np.testing.assert_array_equal(result, fixtures.test_gradient(64, 64))


def test_print():
    _, console = run_script(
        """
        print_line("hello world");
        print_line("second line");
        """
    )
    assert any("hello world" in l for l in console)
    assert any("second line" in l for l in console)


def test_clamp():
    _, console = run_script(
        """
        let v = clamp(300, 0, 255);
        print_line(`${v}`);
        """
    )
    assert console[-1] == "255"


def test_syntax_error():
    with pytest.raises(ScriptError):
        run_script("let x = ;")


def test_runtime_error_div_zero():
    with pytest.raises(ScriptError):
        run_script("let x = 1 / 0;")


def test_script_invert_matches_native():
    script_result, _ = run_script("apply_invert();")
    native = np.asarray(adj.invert_colors(fixtures.test_gradient(64, 64)))
    np.testing.assert_array_equal(script_result, native)


def test_select_rect_limits_effect():
    result, _ = run_script(
        """
        select_rect(10, 10, 30, 30);
        fill_selected(255, 0, 0, 255);
        """
    )
    np.testing.assert_array_equal(result[20, 20, :3], [255, 0, 0])
    assert result[5, 5, 0] != 255


def test_select_ellipse():
    result, _ = run_script(
        """
        select_ellipse(32.0, 32.0, 15.0, 15.0);
        fill_selected(255, 0, 255, 255);
        """
    )
    np.testing.assert_array_equal(result[32, 32, :3], [255, 0, 255])
    assert result[0, 0, 0] == 0 and result[0, 0, 1] == 255


def test_clear_selection():
    result, _ = run_script(
        """
        select_rect(0, 0, 10, 10);
        clear_selection();
        fill_selected(0, 0, 255, 255);
        """
    )
    assert result[50, 50, 2] == 255


def test_has_selection():
    _, console = run_script(
        """
        print_line("before: " + has_selection());
        select_rect(0, 0, 10, 10);
        print_line("after: " + has_selection());
        clear_selection();
        print_line("cleared: " + has_selection());
        """
    )
    assert any("before: false" in l for l in console)
    assert any("after: true" in l for l in console)
    assert any("cleared: false" in l for l in console)


def test_invert_selection():
    result, _ = run_script(
        """
        select_rect(10, 10, 54, 54);
        invert_selection();
        fill_selected(255, 0, 255, 255);
        """
    )
    assert result[0, 0, 0] == 255 and result[0, 0, 2] == 255
    assert not (result[32, 32, 0] == 255 and result[32, 32, 2] == 255)


def test_delete_selected():
    result, _ = run_script(
        """
        select_rect(20, 20, 44, 44);
        delete_selected();
        """
    )
    assert result[32, 32, 3] == 0
    assert result[5, 5, 3] > 0


def test_selected_for_each_pixel():
    result, _ = run_script(
        """
        select_rect(0, 0, 32, 64);
        for_each_pixel(|x, y, r, g, b, a| {
            if is_selected(x, y) {
                [255 - r, 255 - g, 255 - b, a]
            } else {
                [r, g, b, a]
            }
        });
        """
    )
    assert result[32, 5, 0] > 200
    assert result[32, 50, 0] > 100


def test_user_function_and_loops():
    _, console = run_script(
        """
        fn double(x) { x * 2 }
        let total = 0;
        for i in 0..5 {
            total += double(i);
        }
        print_line(`${total}`);
        """
    )
    assert console[-1] == "20"


def test_canvas_ops_recorded():
    img = fixtures.test_gradient(64, 64)
    out, w, h, _console, ops = execute_script_sync("rotate_canvas_90cw();", img, 64, 64)
    assert (w, h) == (64, 64)
    assert len(ops) == 1 and ops[0].kind == "rot90cw"


def test_resize_image_script():
    img = fixtures.test_gradient(64, 64)
    out, w, h, _c, ops = execute_script_sync(
        'resize_image(32, 32, "bilinear");', img, 64, 64
    )
    assert (w, h) == (32, 32)
    assert np.asarray(out).shape == (32, 32, 4)
    assert ops[0].kind == "resize_image"


def test_rand_deterministic_with_seed():
    img = fixtures.test_gradient(8, 8)
    src = "print_line(`${rand_int(0, 100)}`);"
    _, _, _, c1, _ = execute_script_sync(src, img, 8, 8, rng_seed=1234)
    _, _, _, c2, _ = execute_script_sync(src, img, 8, 8, rng_seed=1234)
    assert c1 == c2


# -- language extensions: switch, maps, `in`, do-while ------------------------


def test_switch_expression():
    _, console = run_script(
        """
        let mode = "dark";
        let label = switch mode {
            "bright" => "B",
            "dark" | "dim" => "D",
            _ => "?"
        };
        print_line(label);
        let n = switch 2 { 1 => 10, 2 => { let q = 20; q + 2 }, _ => 0 };
        print_line(`${n}`);
        let fallthrough = switch 99 { 1 => 10, _ => -1 };
        print_line(`${fallthrough}`);
        """
    )
    assert console == ["D", "22", "-1"]


def test_object_maps():
    _, console = run_script(
        """
        let m = #{a: 1, "b": 2};
        m.c = m.a + m.b;
        m.a += 10;
        m["d"] = 4;
        m["d"] *= 3;
        print_line(`${m}`);
        print_line(`${m.keys()}`);
        print_line(`${m.len}`);
        print_line(`${m.contains("b")} ${m.remove("b")} ${m.contains("b")}`);
        """
    )
    assert console == [
        '#{"a": 11, "b": 2, "c": 3, "d": 12}',
        '["a", "b", "c", "d"]',
        "4",
        "true 2 false",
    ]


def test_in_operator():
    _, console = run_script(
        """
        print_line(`${3 in 0..5} ${5 in 0..5} ${5 in 0..=5}`);
        print_line(`${"right" in "brightness"}`);
        print_line(`${2 in [1, 2, 3]} ${9 in [1, 2, 3]}`);
        print_line(`${"a" in #{a: 1}} ${"z" in #{a: 1}}`);
        """
    )
    assert console == ["true false true", "true", "true false", "true false"]


def test_do_while_until():
    _, console = run_script(
        """
        let total = 0;
        let i = 0;
        do { total += i; i += 1; } while i < 5
        print_line(`${total}`);
        let j = 10;
        do { j -= 1; } until j <= 3
        print_line(`${j}`);
        let ran = 0;
        do { ran += 1; } while false
        print_line(`${ran}`);
        """
    )
    assert console == ["10", "3", "1"]


# -- vectorized-closure correctness (round-2 regressions) --------------------
# The for_each_pixel/map_channels fast path may only run when a purity scan
# proves the closure has no observable side effects; rand_* must advance the
# xorshift64 state once per pixel exactly like scripting.rs:1217-1256.


def run_seeded(source, size=4, seed=12345):
    img = fixtures.test_gradient(size, size)
    out, w, h, console, _ops = execute_script_sync(
        source, img, size, size, None, rng_seed=seed
    )
    return np.asarray(out).reshape(h, w, 4), console


def test_rand_in_closure_is_per_pixel():
    result, _ = run_seeded(
        """
        for_each_pixel(|x, y, r, g, b, a| [rand_int(0, 200), g, b, a]);
        """,
        size=8,
    )
    rs = result[..., 0].ravel()
    # 64 independent draws from [0,200) collide sometimes but can't all be
    # one value (the round-1 bug: a single broadcast draw).
    assert len(set(rs.tolist())) > 16, rs


def test_rand_in_closure_matches_scalar_semantics():
    # Reproduce the exact per-pixel xorshift64 stream on the host and
    # compare: row-major order, one advance per callback.
    seed = 987654321
    result, _ = run_seeded(
        "for_each_pixel(|x, y, r, g, b, a| [rand_int(0, 200), g, b, a]);",
        size=4,
        seed=seed,
    )
    mask64 = (1 << 64) - 1
    s = seed
    expect = []
    for _ in range(16):
        s ^= (s << 13) & mask64
        s ^= s >> 7
        s ^= (s << 17) & mask64
        expect.append(s % 200)
    np.testing.assert_array_equal(result[..., 0].ravel(), expect)


def test_closure_console_effects_exact():
    # print-then-data-dependent-branch: the round-1 bug emitted the print
    # from the abandoned vectorized attempt too (17 lines instead of 16).
    _, console = run_seeded(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            print_line(`${x},${y}`);
            if r > 100 { [255, g, b, a] } else { [0, g, b, a] }
        });
        """,
        size=4,
    )
    assert len(console) == 16
    assert console[0] == "0,0" and console[-1] == "3,3"


def test_block_statement_then_array_literal_parses():
    # Rhai parses `{ if c { … } [r,g,b,a] }` as an if-STATEMENT followed by
    # an array expression (the closure's value) — not indexing into the if.
    result, _ = run_script(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let rr = r;
            if rr > 100 { rr = 255; }
            [rr, g, b, a]
        });
        """
    )
    img = fixtures.test_gradient(64, 64)
    expect = img.copy()
    expect[..., 0] = np.where(img[..., 0] > 100, 255, img[..., 0])
    np.testing.assert_array_equal(result, expect)


def test_pure_closure_with_branch_matches_numpy():
    # Data-dependent control flow in a pure closure: vectorized attempt
    # fails on array truthiness and falls back to the scalar loop; output
    # must match the reference semantics exactly.
    result, console = run_script(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            if (x + y) % 2 == 0 { [r, 0, 0, a] } else { [0, g, 0, a] }
        });
        """
    )
    assert console == []
    img = fixtures.test_gradient(64, 64)
    yy, xx = np.mgrid[0:64, 0:64]
    even = (xx + yy) % 2 == 0
    expect = np.zeros_like(img)
    expect[..., 0] = np.where(even, img[..., 0], 0)
    expect[..., 1] = np.where(even, 0, img[..., 1])
    expect[..., 3] = img[..., 3]
    np.testing.assert_array_equal(result, expect)


def test_captured_mutation_not_vectorized():
    # A closure accumulating into a captured variable must run per pixel.
    _, console = run_script(
        """
        let total = 0;
        for_each_pixel(|x, y, r, g, b, a| { total += 1; });
        print_line(`${total}`);
        """
    )
    assert console == [f"{64 * 64}"]


def test_purity_scanner_classification():
    from paintfe_tpu.scripting.api import closure_is_pure
    from paintfe_tpu.scripting.interp import Closure
    from paintfe_tpu.scripting.rhai_ast import parse

    def closure_of(src):
        prog = parse(src)
        expr = prog[1][0][1]  # ('expr', ('closure', …), …)
        assert expr[0] == "closure"
        return Closure(expr[1], expr[2], [])

    pure = closure_of("|x, y, r, g, b, a| [255 - r, g, b, a]")
    assert closure_is_pure(pure)
    pure_math = closure_of("|r, g, b, a| { let l = clamp(r + 10, 0, 255); [l, g, b, a] }")
    assert closure_is_pure(pure_math)
    local_mut = closure_of("|r, g, b, a| { let v = r; v += 1; [v, g, b, a] }")
    assert closure_is_pure(local_mut)
    rng = closure_of("|r, g, b, a| [rand_int(0, 10), g, b, a]")
    assert not closure_is_pure(rng)
    prints = closure_of("|r, g, b, a| { print_line(`x`); [r, g, b, a] }")
    assert not closure_is_pure(prints)
    setter = closure_of("|x, y, r, g, b, a| { set_pixel(x, y, 0, 0, 0, 255); }")
    assert not closure_is_pure(setter)
    # std map mutators on CAPTURED state must disqualify vectorization
    # (round-5 review: m.set once-on-arrays would drop per-pixel ordering)
    map_set = closure_of('|x| { m.set("last", x); x }')
    assert not closure_is_pure(map_set)
    map_mixin = closure_of("|x| { m.mixin(#{ a: x }); x }")
    assert not closure_is_pure(map_mixin)
    # ...while the same mutators on a LOCAL map stay pure
    local_map = closure_of('|x| { let m = #{}; m.set("k", x); m.get("k") }')
    assert closure_is_pure(local_map)


# -- language-tail conformance (switch ranges, string methods, nesting) ------


def test_switch_range_patterns():
    _, console = run_script(
        """
        for v in [3, 15, 120, 255] {
            let label = switch v {
                0..10 => "low",
                10..=100 => "mid",
                _ => "high",
            };
            print_line(label);
        }
        """
    )
    assert console == ["low", "mid", "high", "high"]


def test_string_method_tail():
    _, console = run_script(
        """
        let s = "  Paint FE  ";
        s.trim();
        print_line(`[${s}]`);
        print_line(`${s.index_of("FE")}`);
        print_line(`${s.sub_string(6, 2)}`);
        print_line(`${s.sub_string(6)}`);
        print_line(`${s.starts_with("Paint")} ${s.ends_with("FE")}`);
        s.replace("FE", "GPU");
        print_line(s);
        s.make_upper();
        print_line(s);
        s.truncate(5);
        print_line(s);
        let parts = "a,b,c".split(",");
        print_line(`${parts.len} ${parts[1]}`);
        """
    )
    assert console == [
        "[Paint FE]", "6", "FE", "FE", "true true",
        "Paint GPU", "PAINT GPU", "PAINT", "3 b",
    ]


def test_nested_closures_capture():
    _, console = run_script(
        """
        let make_adder = |n| |x| x + n;
        let add5 = make_adder.call(5);
        print_line(`${add5.call(10)}`);
        let fns = [];
        for i in 0..3 {
            fns.push(make_adder.call(i * 100));
        }
        print_line(`${fns[0].call(1)} ${fns[1].call(1)} ${fns[2].call(1)}`);
        """
    )
    assert console == ["15", "1 101 201"]


def test_differential_vectorized_vs_scalar_fuzz():
    """Differential fuzz: random pure closures run once vectorized and once
    with a print_line prepended (which forces the scalar per-pixel path).
    Pixels must be bit-identical between the two paths."""
    import random

    rng = random.Random(20260816)
    leaves = ["x", "y", "r", "g", "b", "a", "17", "3", "128", "255"]

    def gen_expr(depth):
        if depth == 0:
            return rng.choice(leaves)
        op = rng.choice(["+", "-", "*", "%", "min", "max", "clamp"])
        a = gen_expr(depth - 1)
        bch = gen_expr(depth - 1)
        if op == "min":
            return f"min_i({a}, {bch})"
        if op == "max":
            return f"max_i({a}, {bch})"
        if op == "clamp":
            return f"clamp({a}, 0, 255)"
        if op == "%":
            return f"(({a}) % 251 + 251) % 251"
        return f"(({a}) {op} ({bch}))"

    for trial in range(12):
        chans = [gen_expr(rng.randint(1, 3)) for _ in range(3)]
        body = f"[clamp({chans[0]},0,255), clamp({chans[1]},0,255), clamp({chans[2]},0,255), a]"
        fast = f"for_each_pixel(|x, y, r, g, b, a| {body});"
        slow = (
            "for_each_pixel(|x, y, r, g, b, a| {\n"
            '  print("");\n'
            f"  {body}\n"
            "});"
        )
        out_fast, _ = run_seeded(fast, size=8)
        out_slow, _ = run_seeded(slow, size=8)
        np.testing.assert_array_equal(out_fast, out_slow, err_msg=f"trial {trial}: {body}")


def test_parser_fuzz_no_crashes():
    """Parser robustness: random token soup must raise ScriptError, never
    an unhandled Python exception."""
    import random

    rng = random.Random(42)
    atoms = [
        "let", "if", "else", "{", "}", "(", ")", "[", "]", "|", "==", "=",
        "+", "-", "*", "/", "fn", "for", "in", "..", ";", ",", "x", "1",
        "2.5", '"s"', "`t${x}`", "while", "return", "=>", "switch", "#{", ":",
    ]
    for _ in range(300):
        src = " ".join(rng.choice(atoms) for _ in range(rng.randint(1, 25)))
        try:
            execute_script_sync(src, fixtures.test_gradient(4, 4), 4, 4, None)
        except ScriptError:
            pass  # expected for garbage


# ---------------------------------------------------------------------------
# Round-2 review regressions: purity-scanner soundness + Rhai value semantics
# ---------------------------------------------------------------------------


def test_impure_call_in_assignment_target_index():
    """rand_* hidden in an assignment-target index forces the scalar path
    (per-pixel RNG advance), not one broadcast draw."""
    out, console = run_script(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let v = [0, 0, 0, 0];
            v[rand_int(0, 3)] = 120;
            [clamp(r + v[0], 0, 255), g, b, a]
        });
        """
    )
    vals = set(np.asarray(out)[..., 0].reshape(-1).tolist())
    # gradient base values plus +120 on a random per-pixel subset: many
    # distinct outcomes, not a single broadcast value
    assert len(vals) > 8


def test_let_copies_arrays_value_semantics():
    """Rhai clones on assignment: `let t = log` must not alias."""
    _, console = run_script(
        """
        let log = [];
        for_each_pixel(|x, y, r, g, b, a| {
            let t = log;
            t.push(1);
            [r, g, b, a]
        });
        print_line(`${log.len()}`);
        """
    )
    assert console[-1] == "0"


def test_script_fn_args_are_copied():
    _, console = run_script(
        """
        fn stomp(arr) { arr.push(99); arr.len() }
        let a = [1, 2];
        let n = stomp(a);
        print_line(`${n} ${a.len()}`);
        """
    )
    assert console[-1] == "3 2"


def test_user_fn_shadowing_host_name_runs_scalar():
    """A script fn shadowing a host name is impure by assumption: the
    closure runs per pixel and its prints appear exactly once per pixel."""
    _, console = run_script(
        """
        fn tag() { print_line("hi"); 1 }
        for_region(0, 0, 4, 4, |x, y, r, g, b, a| {
            let q = tag();
            [r, g, b, a]
        });
        """
    )
    assert sum(1 for line in console if line == "hi") == 16


def test_let_bound_closure_shadowing_host_name_runs_scalar():
    """A let-bound closure shadowing a pure host name must defeat the
    vectorized fast path: interp.call_function resolves scope variables
    before host fns, so `abs` here is the side-effecting closure and its
    prints must appear exactly once per pixel (reference Rhai semantics).
    Mirrors the fn-shadow case above for variable bindings."""
    _, console = run_script(
        """
        let abs = |v| { print_line("shadow"); v };
        for_region(0, 0, 4, 4, |x, y, r, g, b, a| {
            let q = abs(r);
            [q, g, b, a]
        });
        """
    )
    assert sum(1 for line in console if line == "shadow") == 16


def test_string_inplace_on_indexed_receiver():
    _, console = run_script(
        """
        let a = ["hello"];
        a[0].make_upper();
        let m = #{ s: "world" };
        m.s.make_upper();
        print_line(a[0] + " " + m.s);
        """
    )
    assert console[-1] == "HELLO WORLD"


def test_inplace_op_after_jax_backed_apply():
    """A jax-routed apply_* leaves ctx.pixels as a device-array view; the
    next in-place pointwise op (apply_invert, set_pixel) must still be able
    to write (regression: 'assignment destination is read-only')."""
    result, _ = run_script("apply_blur(1.0);\napply_invert();\nset_pixel(0, 0, 1, 2, 3, 4);")
    np.testing.assert_array_equal(result[0, 0], [1, 2, 3, 4])


# -- predicated vectorization (round-4: VERDICT #2) --------------------------
# Data-dependent `if` in a PURE closure is if-converted: both branches run on
# whole arrays and every scope write plus the value merges through np.where
# (interp._predicated_if).  Every case below must be bit-identical to the
# scalar per-pixel loop, which stays the semantic oracle.  Mirrors the
# reference's compiled per-pixel closures (scripting.rs:437-495).

import paintfe_tpu.scripting.api as _api_mod


def _run_both_ways(source, size=48, seed=7):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 4), dtype=np.uint8)
    out_v, _, _, con_v, _ = execute_script_sync(source, img.copy(), size, size)
    orig = _api_mod.closure_is_pure
    _api_mod.closure_is_pure = lambda *a, **k: False
    try:
        out_s, _, _, con_s, _ = execute_script_sync(source, img.copy(), size, size)
    finally:
        _api_mod.closure_is_pure = orig
    assert con_v == con_s
    np.testing.assert_array_equal(np.asarray(out_v), np.asarray(out_s))
    return np.asarray(out_v)


def test_predicated_if_else_chain():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let lum = (r * 77 + g * 151 + b * 28) >> 8;
            if lum > 128 {
                let boost = lum - 128;
                [r + boost / 2, g, b - boost / 4, a]
            } else if lum > 64 {
                [r, g + 10, b, a]
            } else {
                [255 - r, 255 - g, 255 - b, a]
            }
        });
        """
    )


def test_predicated_nested_if():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            if r > 100 {
                if g > 100 { [255, 255, b, a] } else { [255, 0, b, a] }
            } else {
                [0, g, b, a]
            }
        });
        """
    )


def test_predicated_branch_writes_local():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let v = r;
            let w = g;
            if r > g { v = 255; w = w / 2; } else { v += 5; }
            [v, w, b, a]
        });
        """
    )


def test_predicated_logical_ops_and_negation():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let hot = r > 200 || g > 200;
            let cold = !(r > 50) && b < 128;
            if hot && !cold { [255, g, b, a] }
            else if cold || b % 3 == 0 { [r, 255, b, a] }
            else { [r, g, 255, a] }
        });
        """
    )


def test_predicated_int_division_truncates_like_scalar():
    # (r - 128) / 3 on negatives: Rust i64 truncates toward zero, numpy //
    # floors — the vectorized path must not diverge.
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let d = (r - 128) / 3;
            let m = (g - 128) % 5;
            if d < 0 { [0 - d, m + 128, b, a] } else { [d, m + 128, b, a] }
        });
        """
    )


def test_predicated_spatial_and_data_mixed_condition():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            if x < 10 || (y > 20 && r > 128) { [255 - r, g, b, a] }
            else { [r, 255 - g, b, a] }
        });
        """
    )


def test_predicated_if_statement_mutates_then_falls_through():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let rr = r;
            if rr > 100 { rr = 255; }
            if rr < 30 { rr = 30; }
            [rr, g, b, a]
        });
        """
    )


def test_predicated_loop_over_static_range_with_branch():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let acc = 0;
            for i in 0..3 {
                if r > i * 80 { acc += 40; }
            }
            [acc, g, b, a]
        });
        """
    )


def test_predicated_unsupported_merge_falls_back_identically():
    # Branches return different-length arrays: if-conversion can't merge →
    # scalar loop must produce the (reference-exact) result anyway.
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            if r > 128 { [255, 0, 0, 255] } else { [r, g, b] }
        });
        """,
        size=16,
    )


def test_predicated_path_actually_vectorizes():
    # 64x64 branchy closure: the scalar loop would cost >=4096 closure
    # bodies; if-conversion runs the body a handful of times on arrays.
    from paintfe_tpu.scripting.api import ScriptContext, build_host_fns
    from paintfe_tpu.scripting.interp import Interpreter

    img = fixtures.test_gradient(64, 64)
    ctx = ScriptContext(np.asarray(img, np.uint8), 64, 64, None, None)
    ref = {}
    interp = Interpreter(build_host_fns(ctx, ref))
    ref["interp"] = interp
    interp.run(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            if r > 128 { [255 - r, g, b, a] } else { [r, 255 - g, b, a] }
        });
        """
    )
    assert interp.ops < 2000, f"fell back to scalar loop ({interp.ops} ops)"


def _err_both_ways(source, size=16, seed=7):
    """Run with the vectorizer enabled and with it disabled; both must
    raise the SAME ScriptError (fallback-to-scalar error parity)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 4), dtype=np.uint8)
    with pytest.raises(ScriptError) as ev:
        execute_script_sync(source, img.copy(), size, size)
    orig = _api_mod.closure_is_pure
    _api_mod.closure_is_pure = lambda *a, **k: False
    try:
        with pytest.raises(ScriptError) as es:
            execute_script_sync(source, img.copy(), size, size)
    finally:
        _api_mod.closure_is_pure = orig
    assert ev.value.message == es.value.message
    return ev.value.message


def test_vectorized_not_on_int_falls_back_to_scalar_error():
    # '!' on a non-bool errors in the scalar oracle; the vectorized pass
    # must not silently compute ~int (round-4 review regression)
    msg = _err_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| { let v = !r; [g, g, g, a] });")
    assert "bool" in msg
    msg = _err_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| { [!r, g, b, a] });")
    assert "bool" in msg


def test_vectorized_shift_range_falls_back_to_scalar_error():
    # shift counts outside 0..63 raise "integer overflow" per pixel in the
    # scalar oracle; the vectorized pass must bail, not do numpy UB
    msg = _err_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| "
        "{ let v = 1 << (r / 16 + 60); [v % 256, g, b, a] });")
    assert "integer overflow" in msg


def test_vectorized_shift_in_range_still_vectorizes():
    _run_both_ways(
        """
        for_each_pixel(|x, y, r, g, b, a| {
            let v = (r / 16) << 3;
            let w = g >> 2;
            if v > w { [v, w, b, a] } else { [w, v, b, a] }
        });
        """
    )


def test_float_channel_keeps_old_value():
    # Rhai commits channels via as_int().unwrap_or(old) (scripting.rs:466-
    # 471): a FLOAT result is NOT an INT, so the channel silently keeps its
    # previous value — no truncation, no error
    img = np.zeros((4, 4, 4), np.uint8)
    img[..., 0] = 77
    img[..., 3] = 255
    out, _, _, _, _ = execute_script_sync(
        "for_each_pixel(|x, y, r, g, b, a| { [r + 0.5, 9, b, a] });",
        img.copy(), 4, 4)
    out = np.asarray(out)
    assert (out[..., 0] == 77).all()   # float result -> old kept
    assert (out[..., 1] == 9).all()    # int result committed
    _run_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| { [r + 0.5, g, b, a] });")


def test_bool_channel_keeps_old_value():
    img = np.zeros((4, 4, 4), np.uint8)
    img[..., 0] = 50
    img[..., 3] = 255
    out, _, _, _, _ = execute_script_sync(
        "for_each_pixel(|x, y, r, g, b, a| { [r > 10, g, b, a] });",
        img.copy(), 4, 4)
    assert (np.asarray(out)[..., 0] == 50).all()
    _run_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| { [r > 10, g, b, a] });")


def test_integral_float_channels_also_keep_old():
    # even INTEGRAL floats are not INTs to as_int(): 10.0 keeps old too
    img = np.full((4, 4, 4), 33, np.uint8)
    out, _, _, _, _ = execute_script_sync(
        "for_each_pixel(|x, y, r, g, b, a| { [(r / 2) * 2.0, g, b, a] });",
        img.copy(), 4, 4)
    assert (np.asarray(out)[..., 0] == 33).all()
    _run_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| { [(r / 2) * 2.0, g, b, a] });")


def test_for_region_non_closure_is_script_error():
    img = np.zeros((8, 8, 4), np.uint8)
    with pytest.raises(ScriptError, match="closure"):
        execute_script_sync("for_region(0, 0, 2, 2, 42);", img, 8, 8)


def test_async_engine_bug_still_sends_terminal_message(monkeypatch):
    """Even an uncategorized engine escape must produce the terminal error
    message — a consumer draining the queue would hang forever otherwise."""
    import queue as _q

    from paintfe_tpu.scripting import engine as eng

    def boom(*a, **k):
        raise RuntimeError("synthetic engine bug")

    monkeypatch.setattr(eng, "_run_script", boom)
    img = np.zeros((4, 4, 4), np.uint8)
    thread, messages = eng.execute_script_async("let x = 1;", img, 4, 4)
    thread.join(timeout=30)
    assert not thread.is_alive()
    kinds = []
    while True:
        try:
            m = messages.get_nowait()
        except _q.Empty:
            break
        kinds.append(m.kind)
    assert "error" in kinds


def test_canvas_op_replay_keeps_selection_on_flips():
    """apply_canvas_ops never touches the selection (scripting.rs:1640-1723)
    unless the canvas dimensions changed and the dense mask shape went
    stale; flip_v used to clear it while flip_h kept it."""
    from paintfe_tpu.core.canvas import Canvas
    from paintfe_tpu.scripting.api import CanvasOpRequest
    from paintfe_tpu.scripting.engine import apply_canvas_ops

    for kind in ("flip_h", "flip_v", "rot180"):
        c = Canvas.new(16, 16, background=(1, 2, 3, 255))
        sel = np.zeros((16, 16), np.uint8)
        sel[2:6, 2:6] = 255
        c.selection = sel.copy()
        apply_canvas_ops(c, [CanvasOpRequest(kind=kind)], skip_layer=0)
        assert c.selection is not None, kind
    # dims change -> stale dense mask must go
    c = Canvas.new(16, 8, background=(1, 2, 3, 255))
    c.selection = np.zeros((8, 16), np.uint8)
    apply_canvas_ops(c, [CanvasOpRequest(kind="rot90cw")], skip_layer=0)
    assert c.selection is None


# -- snapshot bulk-loop semantics (scripting.rs:446-495) ------------------------


def test_get_pixel_inside_loop_reads_original():
    """The loop runs over a CLONE; get_pixel reads the engine's (original)
    pixels, so a sweep that copies the left neighbour sees PRE-loop values
    everywhere, not the freshly written ones."""
    img = np.zeros((1, 4, 4), np.uint8)
    img[0, :, 0] = [10, 20, 30, 40]
    img[0, :, 3] = 255
    out, _, _, _, _ = execute_script_sync(
        "for_each_pixel(|x, y, r, g, b, a| {"
        " if x == 0 { [200, g, b, a] } else { [get_r(x - 1, y), g, b, a] }"
        "});", img, 4, 1)
    # live-loop semantics would propagate 200 rightward; snapshot keeps
    # each pixel's ORIGINAL left neighbour
    np.testing.assert_array_equal(np.asarray(out)[0, :, 0], [200, 10, 20, 30])


def test_set_pixel_inside_loop_clobbered_on_success():
    img = np.zeros((2, 2, 4), np.uint8)
    img[..., 3] = 255
    out, _, _, _, _ = execute_script_sync(
        "for_each_pixel(|x, y, r, g, b, a| {"
        " set_pixel(0, 0, 111, 111, 111, 255); [r, 7, b, a] });",
        img, 2, 2)
    out = np.asarray(out)
    # the final clone writeback replaces the whole buffer: the set_pixel
    # side write is gone, the closure's returned channels win
    assert out[0, 0, 0] == 0 and (out[..., 1] == 7).all()


def test_set_pixel_inside_loop_persists_on_error():
    img = np.zeros((2, 2, 4), np.uint8)
    img[..., 3] = 255
    out, _, _, _, _ = execute_script_sync(
        "try { for_each_pixel(|x, y, r, g, b, a| {"
        " set_pixel(0, 0, 111, 0, 0, 255);"
        " if x == 1 { throw \"x\"; } [9, 9, 9, 255] }); } catch (e) {}",
        img, 2, 2)
    out = np.asarray(out)
    # writeback skipped -> the [9,9,9] results are discarded but the
    # direct set_pixel write to the live buffer stays
    assert out[0, 0, 0] == 111
    assert not (out[..., 1] == 9).any()


def test_for_region_negative_sum_wraps_to_full_extent():
    # (rx + rw) as u32: -3 wraps to ~4e9 and clamps to the canvas edge
    img = np.zeros((4, 4, 4), np.uint8)
    out, _, _, _, _ = execute_script_sync(
        "for_region(2, 0, -5, 4, |x, y, r, g, b, a| { [255, g, b, a] });",
        img, 4, 4)
    out = np.asarray(out)
    assert (out[:, 2:, 0] == 255).all()   # x0=max(2,0) .. wrapped end=width
    assert (out[:, :2, 0] == 0).all()


def test_purity_scan_rejects_fnptr_call_and_curry():
    """.call() on a captured closure can execute impure code the static
    scan cannot see through: if the vectorizer wrongly ran the body once
    on whole arrays, f's captured-state push would fire ONCE (or with
    array args) instead of once per pixel."""
    img = np.zeros((4, 4, 4), np.uint8)
    _, _, _, console, _ = execute_script_sync(
        "let log = [];"
        "let f = |v| { log.push(v); v + 1 };"
        "for_each_pixel(|x, y, r, g, b, a| { [f.call(r), g, b, a] });"
        "print_line(`${log.len()}`);", img, 4, 4)
    assert console == ["16"]


def test_vectorized_i64_checked_overflow():
    # in-range big products must agree between the vectorized pass (which
    # falls back near 2^62) and the scalar loop...
    _run_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| {"
        " let big = (r - 128) * 18014398509481984;"   # * 2^54: in range
        " let v = if big > 0 { 255 } else { 0 };"
        " [v, g, b, a] });", size=16)
    # ...and past i64::MAX both tiers raise the CHECKED-arithmetic error
    # (Rhai's default build; Python bigints must never leak)
    msg = _err_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| {"
        " let big = (r + 2) * 144115188075855872;"    # * 2^57: overflows
        " [if big > 0 { 255 } else { 0 }, g, b, a] });")
    assert "integer overflow" in msg
    msg = _err_both_ways(
        "for_each_pixel(|x, y, r, g, b, a| {"
        " let big = (r + 1) ** 9; [b, g, b, a] });")
    assert "integer overflow" in msg


def test_math_fn_ieee_corners():
    _, console = run_script(
        """
        print_line(`${sqrt(-1.0)}`);
        print_line(`${pow(-2.0, 0.5)}`);
        print_line(`${pow(0.0, -1.0)}`);
        print_line(`${round(0.49999999999999994)}`);
        print_line(`${round(-0.5)}`);
        print_line(`${(0.49999999999999994).round()}`);
        print_line(`${(-1.5).round()}`);
        print_line(`${(-1.0).sqrt()}`);
        print_line(`${min(1.0, 0.0/0.0)}`);
        print_line(`${max(0.0/0.0, 2.0)}`);
        """
    )
    # f64 semantics: sqrt(neg)=NaN, powf is full IEEE, round is half away
    # from zero via the exact fraction (floor(x+0.5) would print 1.0 for
    # the 0.5-2^-54 corner), min/max return the non-NaN operand
    assert console == ["NaN", "NaN", "inf", "0.0", "-1.0", "0.0", "-2.0",
                       "NaN", "1.0", "2.0"]
