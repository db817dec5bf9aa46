"""Window functions (periodic convention, matching the golden model)."""

from __future__ import annotations

import jax.numpy as jnp


def hann(n: int, dtype=jnp.float32) -> jnp.ndarray:
    """Periodic Hann window."""
    k = jnp.arange(n, dtype=dtype)
    return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * k / n)


def resolve_window(window, cfg):
    """The window convention at every cfg-level entry point: False for
    none, True for the config's kind (cfg.window_kind), or an explicit
    kind string (golden.window_fn) that overrides the config."""
    return cfg.window_kind if window is True else window


def make_window(n: int, kind: str, dtype=jnp.float32) -> jnp.ndarray:
    """Window of the named kind, computed in float64 by the golden model
    and cast — identical taps to the DFT-matrix paths.  'hann' keeps the
    original in-dtype formula (bit-compatible with round-1..3 FFT-path
    outputs)."""
    if kind == "hann":
        return hann(n, dtype)
    from mmradar.golden import window_fn

    return jnp.asarray(window_fn(n, kind), dtype)
