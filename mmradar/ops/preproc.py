"""Clutter removal + zero-padding (device path).

The reference fuses base-frame subtraction with tail zero-fill in
``cudaDataExtension_kernel`` (acceleration.cu:152-166).  Here it is one
fused XLA elementwise+pad; the kernel's off-by-one bug (element at
``idx == oldSize`` neither zeroed nor subtracted, strict ``>`` at
acceleration.cu:156) is NOT reproduced — the CPU path
(cudaBenchMarking.cpp:277-285) is the contract.
"""

from __future__ import annotations

import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG


def clutter_subtract_pad(
    rx0: jnp.ndarray,
    base_rx0: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> jnp.ndarray:
    """(frame - base) zero-padded to the FFT size.

    Args:
      rx0: complex64 (..., rx_samples).
      base_rx0: complex64 (rx_samples,) — broadcast over the batch.

    Returns:
      complex64 (..., fft_size).
    """
    diff = rx0 - base_rx0
    pad = [(0, 0)] * (diff.ndim - 1) + [(0, cfg.fft_size - cfg.rx_samples)]
    return jnp.pad(diff, pad)


def mean_clutter_removal(cube: jnp.ndarray) -> jnp.ndarray:
    """Alternative clutter removal for the range-Doppler path: subtract the
    per-(rx, sample) mean over chirps (removes zero-Doppler returns without
    needing an empty-scene base frame)."""
    return cube - jnp.mean(cube, axis=-2, keepdims=True)


def declutter_planes(
    re: jnp.ndarray,
    im: jnp.ndarray,
    mode: str,
    base_pair=None,
    axis: int = -3,
    stride: int = 1,
):
    """Resolved-clutter-mode dispatch on a split re/im plane pair.

    One home for the base/mean/mti branch every split-plane range path
    repeats (fused XLA, distributed fused shard):
    ``mode`` is an already-resolved ``RadarConfig.effective_clutter``
    value; ``base_pair`` is the matching (re, im) base planes for
    'base'; ``axis``/``stride`` locate the chirp axis (stride = num_tx
    on a TDM-interleaved axis).
    """
    if mode == "base":
        return re - base_pair[0], im - base_pair[1]
    if mode == "mean":
        return (re - jnp.mean(re, axis=axis, keepdims=True),
                im - jnp.mean(im, axis=axis, keepdims=True))
    order = int(mode[-1])
    return (mti_clutter_removal(re, order, axis=axis, stride=stride),
            mti_clutter_removal(im, order, axis=axis, stride=stride))


def mti_clutter_removal(
    x: jnp.ndarray, order: int = 2, axis: int = -2, stride: int = 1
) -> jnp.ndarray:
    """Circular pulse-canceller MTI along slow time.

    Two-pulse (``order=2``): ``y[c] = x[c] - x[c-stride]``; three-pulse
    (``order=3``): ``y[c] = x[c] - 2 x[c-stride] + x[c-2*stride]``, both
    with circular wrap over the CPI (the wrapped difference also pairs
    two returns of the same static scatterer, so DC rejection stays
    exact at the edge).  ``stride`` is ``num_tx`` when the chirp axis
    still interleaves TDM transmitters (pairing same-TX chirps) and 1 on
    a demuxed per-TX axis; the two placements are the same linear map.

    Rejection is exactly zero at zero Doppler per CPI — unlike the mean
    mode it does not assume the clutter equals the scene average, and
    unlike 'base' it needs no empty-scene capture.  The filter response
    over Doppler bin d is ``(1 - e^{-j 2 pi d / D})^(order-1)`` — movers
    away from the notch pass with up to +6 dB (order 2) gain.

    Golden twin: :func:`mmradar.golden.mti_filter`.
    """
    if order not in (2, 3):
        raise ValueError(f"MTI order must be 2 or 3, got {order}")
    prev = jnp.roll(x, stride, axis=axis)
    if order == 2:
        return x - prev
    return x - 2.0 * prev + jnp.roll(x, 2 * stride, axis=axis)
