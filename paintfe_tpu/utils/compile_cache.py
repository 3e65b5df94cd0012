"""Persistent XLA compilation-cache wiring.

The reference CLI is a native binary with zero warmup (src/cli.rs:105-216);
a fresh JAX process instead re-jits every program it touches.  Pointing
XLA's persistent cache at a fixed directory makes every invocation after
the first load serialized executables from disk, so a cold CLI process
reaches the reference's "no warmup" behavior up to the cache-load cost.

Enabled automatically by the CLI and the serving daemon.  Where
$JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory and
nothing here overrides it; otherwise the cache lives in `.xla_cache/` at
the root of the checkout (the path is part of each entry's key, so it must
not move between runs).  PAINTFE_NO_COMPILE_CACHE=1 turns it off.
"""

from __future__ import annotations

import os
import pathlib
from typing import Mapping, Optional

CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".xla_cache"

_stats = {"hits": 0, "misses": 0, "saved_sec": 0.0}
_registered = False


def resolve_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory the persistent cache should use, or None when off:
    $JAX_COMPILATION_CACHE_DIR when set, else the fixed in-checkout
    directory."""
    if environ.get("PAINTFE_NO_COMPILE_CACHE", "") not in ("", "0"):
        return None
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE_DIR)


def enable_persistent_cache() -> Optional[str]:
    """Route every jit compile through the on-disk cache; returns the cache
    directory in use, or None when disabled or unwritable.

    Must run before the programs of interest first compile (config changes
    only affect subsequent compiles); the CLI calls it at startup."""
    import jax

    cache_dir = resolve_cache_dir()
    if cache_dir is None:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None  # unwritable location: run uncached rather than fail
    if cache_dir != jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache everything: a CLI process compiles each program exactly once,
    # so persisting even sub-second compiles is pure win next invocation
    # (the defaults skip entries cheaper than 1 s).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    install_cache_counters()
    return cache_dir


def install_cache_counters() -> dict:
    """Count persistent-cache hits/misses via jax.monitoring (idempotent).
    Returns the live stats dict {hits, misses, saved_sec}."""
    global _registered
    if _registered:
        return _stats
    import jax

    def _on_event(event: str, **kwargs) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            _stats["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            _stats["misses"] += 1

    def _on_duration(event: str, duration_secs: float, **kwargs) -> None:
        if event == "/jax/compilation_cache/compile_time_saved_sec":
            _stats["saved_sec"] += duration_secs

    jax.monitoring.register_event_listener(_on_event)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    _registered = True
    return _stats


def cache_stats() -> dict:
    return dict(_stats)


def cache_report() -> str:
    """One-line summary for --profile output."""
    d = jax_cache_dir()
    where = f" ({d})" if d else " (disabled)"
    return (f"  compile cache{where}: {_stats['hits']} hit(s), "
            f"{_stats['misses']} miss(es), "
            f"{_stats['saved_sec']:.1f}s compile time saved")


def jax_cache_dir() -> Optional[str]:
    import jax

    return jax.config.jax_compilation_cache_dir
