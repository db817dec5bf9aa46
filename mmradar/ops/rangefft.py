"""Range and Doppler FFTs (device path).

The reference hand-rolls a 14-stage radix-2 butterfly FFT as 14 sequential
kernel launches plus a bit-reversal kernel (acceleration.cu:181-247,
506-510).  Here the transform is the XLA FFT HLO — ``jnp.fft.fft``, one
batched call that XLA hands to cuFFT on the GPU (f32, independent of
``cfg.dft_precision``).
"""

from __future__ import annotations

import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG
from mmradar.ops.window import make_window, resolve_window


def range_fft(
    padded: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> jnp.ndarray:
    """Reference-parity 16,384-point range FFT over the padded rx0 slice.

    Args:
      padded: complex64 (..., fft_size).
    """
    return jnp.fft.fft(padded, n=cfg.fft_size, axis=-1)


def range_doppler(
    cube: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> jnp.ndarray:
    """Range-Doppler map: windowed 2D FFT over (chirps, samples).

    Args:
      cube: complex64 (..., chirps, samples) — any leading batch/RX axes.

    Returns:
      complex64 (..., doppler_fft_size, range_fft_size), Doppler axis
      fftshifted (zero velocity centered).  Matches
      ``mmradar.golden.range_doppler_map``.
    """
    x = cube
    window = resolve_window(window, cfg)
    if window:
        x = x * make_window(x.shape[-1], window, x.real.dtype)
        x = x * make_window(x.shape[-2], window, x.real.dtype)[:, None]
    rng = jnp.fft.fft(x, n=cfg.range_fft_size, axis=-1)
    dopp = jnp.fft.fft(rng, n=cfg.doppler_fft_size, axis=-2)
    return jnp.fft.fftshift(dopp, axes=-2)
