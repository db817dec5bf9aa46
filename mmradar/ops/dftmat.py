"""Range-Doppler transform as DFT matrix multiplies.

For radar-sized transforms (range 128, Doppler 128) an N-point DFT is an
(N, N) matmul, and both the Hann window and the zero-padding fold INTO
the DFT matrix:

    RD = F_dopp @ (X * w_r * w_d) @ F_rng^T
       = (F_dopp * w_d_row) @ X @ (F_rng * w_r_col)^T

where ``F_rng`` is the (range_fft, samples) slice of the DFT matrix times
``diag(hann)``.  One complex matmul = 4 real matmuls at (128, 100) x
(100, 128) per (frame, rx) slice, batched over thousands of frames
(``rd_impl='mxu'``/``'planar'``; ``ops/fuseddft.py`` folds the decode in
as well).

This replaces the reference's 14-launch butterfly chain
(acceleration.cu:506-510) with *zero* launches beyond a fused matmul pair,
and numerically matches jnp.fft (both are exact DFTs; error ~1e-6 c64).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from mmradar.config import RadarConfig, DEFAULT_CONFIG
from mmradar.golden import window_fn
from mmradar.ops.window import resolve_window


@lru_cache(maxsize=16)
def _dft_factors(
    n_in: int, n_fft: int, windowed, shift: bool
) -> np.ndarray:
    """(n_fft, n_in) complex64 matrix: windowed, implicitly zero-padding DFT.

    F[k, t] = w[t] * exp(-2pi i k t / n_fft); rows optionally fftshifted.
    ``windowed``: False for none, True for hann, or a window-kind string
    (golden.window_fn).
    """
    k = np.arange(n_fft)[:, None]
    t = np.arange(n_in)[None, :]
    mat = np.exp(-2j * np.pi * k * t / n_fft)
    if windowed:
        kind = "hann" if windowed is True else windowed
        mat = mat * window_fn(n_in, kind)[None, :]
    if shift:
        mat = np.fft.fftshift(mat, axes=0)
    return mat.astype(np.complex64)


def dft_matrix(
    n_in: int, n_fft: int, windowed=False, shift: bool = False
) -> jnp.ndarray:
    return jnp.asarray(_dft_factors(n_in, n_fft, windowed, shift))


def resolve_precision(name: str):
    """cfg.dft_precision -> jax matmul precision (None = the backend's
    default).

    Measured on an H100 (80GB HBM3) against the float64 golden RD power,
    error relative to the map's peak: 'default' ~6e-5 and 'high' ~6e-5
    (TF32-class), 'highest' (full f32) ~2e-7; the fused detect() took
    1.89 / 2.10 / 3.02 ms per 512 frames (PERF.md, PR 1)."""
    if name == "highest":
        return jax.lax.Precision.HIGHEST
    if name == "high":
        return jax.lax.Precision.HIGH
    return None


def _cmatmul_planar(ar, ai, br, bi, eq: str, precision=None):
    """Complex matmul via 4 real matmuls on split planes.

    ``precision=None`` uses the backend's default (TF32 on an H100,
    ~6e-5 of the peak on these DFT sizes); pass
    ``jax.lax.Precision.HIGHEST`` for full f32 (~2e-7)."""
    rr = (
        jnp.einsum(eq, ar, br, precision=precision)
        - jnp.einsum(eq, ai, bi, precision=precision)
    )
    ri = (
        jnp.einsum(eq, ar, bi, precision=precision)
        + jnp.einsum(eq, ai, br, precision=precision)
    )
    return rr, ri


def range_doppler_planes(
    re: jnp.ndarray,
    im: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split-plane range-Doppler: f32 planes in, f32 planes out.

    The planar end-to-end path: decode produces (re, im) planes, this runs
    the windowed 2D DFT as 8 real matmuls, and power/snapshot gathering
    consume the output planes directly — the complex64 RD cube (~270 MB per
    512-frame batch at default geometry) is never materialized.

    Args:
      re, im: float32 (..., chirps, samples).

    Returns:
      (dr, di) float32 (..., doppler_fft, range_fft), Doppler fftshifted.
    """
    window = resolve_window(window, cfg)
    f_rng = dft_matrix(re.shape[-1], cfg.range_fft_size, window)
    f_dop = dft_matrix(re.shape[-2], cfg.doppler_fft_size, window, shift=True)
    prec = resolve_precision(cfg.dft_precision)
    rr, ri = _cmatmul_planar(
        re, im, f_rng.real, f_rng.imag, "...cs,rs->...cr", prec
    )
    return _cmatmul_planar(
        f_dop.real, f_dop.imag, rr, ri, "dc,...cr->...dr", prec
    )


def range_doppler_mxu(
    cube: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
    planar: bool = True,
) -> jnp.ndarray:
    """DFT-matmul range-Doppler map, same contract as
    ops.rangefft.range_doppler.

    Args:
      cube: complex64 (..., chirps, samples).
      planar: decompose the complex matmuls into explicit real f32 matmuls
        on split re/im planes (4 per product) instead of relying on XLA's
        complex-dot lowering; default.

    Returns:
      complex64 (..., doppler_fft, range_fft), Doppler axis fftshifted.
    """
    window = resolve_window(window, cfg)
    if not planar:
        f_rng = dft_matrix(cube.shape[-1], cfg.range_fft_size, window)
        f_dop = dft_matrix(
            cube.shape[-2], cfg.doppler_fft_size, window, shift=True
        )
        prec = resolve_precision(cfg.dft_precision)
        # (..., C, S) @ (S, R) -> (..., C, R); then (D, C) @ (..., C, R)
        rng = jnp.einsum("...cs,rs->...cr", cube, f_rng, precision=prec)
        return jnp.einsum("dc,...cr->...dr", f_dop, rng, precision=prec)
    dr, di = range_doppler_planes(cube.real, cube.imag, cfg, window)
    return jax.lax.complex(dr, di)
