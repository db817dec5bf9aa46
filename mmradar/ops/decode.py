"""ADC decode + layout ops (device path).

The reference burns two CUDA kernels on this — ``cudaShort2Complex_kernel``
(acceleration.cu:91-110) and ``cudaComplexReshape_kernel``
(acceleration.cu:117-150), each with its own global-memory round trip.
Under XLA both collapse into zero-cost layout changes fused into the first
real consumer: the decode is a reshape + dtype cast, the chirp->RX "reshape"
is a transpose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG


def decode_to_cube(
    shorts: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> jnp.ndarray:
    """int16 frame stream -> complex64 radar cube.

    Args:
      shorts: int16 (..., shorts_per_frame) in the on-disk 4-lane interleave
        ``(I0, I1, Q0, Q1)`` (acceleration.cu:102-108).

    Returns:
      complex64 (..., num_rx, num_chirps, num_samples) — RX-major, the
      reference's reshape target (acceleration.cu:138).
    """
    lead = shorts.shape[:-1]
    g = shorts.reshape(lead + (-1, 4)).astype(jnp.float32)
    cplx = jax.lax.complex(g[..., 0:2], g[..., 2:4])
    cplx = cplx.reshape(lead + (cfg.num_chirps, cfg.num_rx, cfg.num_samples))
    # (..., chirp, rx, sample) -> (..., rx, chirp, sample)
    return jnp.swapaxes(cplx, -3, -2)


def decode_to_planes(
    shorts: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """int16 frame stream -> (re, im) float32 planes, same layout as
    :func:`decode_to_cube` ((..., num_rx, num_chirps, num_samples)).

    Planar twin of ``decode_to_cube`` for the end-to-end split-plane
    pipeline: the complex64 cube is never materialized, so the RD stage's
    matmuls read f32 planes straight from the decode with no
    complex<->planar conversion traffic in between.
    """
    lead = shorts.shape[:-1]
    g = shorts.reshape(lead + (-1, 4)).astype(jnp.float32)
    shape = lead + (cfg.num_chirps, cfg.num_rx, cfg.num_samples)
    re = g[..., 0:2].reshape(shape)
    im = g[..., 2:4].reshape(shape)
    return jnp.swapaxes(re, -3, -2), jnp.swapaxes(im, -3, -2)


def rx0_slice(cube: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """RX0's frame slice flattened to (..., chirps*samples) — the input of
    the reference's extension kernel (acceleration.cu:472)."""
    rx0 = cube[..., 0, :, :]
    return rx0.reshape(rx0.shape[:-2] + (cfg.rx_samples,))
