"""Peak detection + range estimation (device path).

The reference copies the full 16K spectrum device->host and scans it
serially on the CPU (``cudaFindAbsMax``, acceleration.cu:391-407, 518-522).
Here the argmax is a single fused device reduce; only scalar results leave
the chip.

Magnitude comparison uses |X|^2 (monotone in |X|) so no sqrt is spent;
``jnp.argmax`` returns the first maximum, matching FindAbsMax's strict ``>``
tie-break (cudaBenchMarking.cpp:199).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG, LIGHT_SPEED


class PeakDetection(NamedTuple):
    """Batched single-target detection results."""

    peak_bin: jnp.ndarray       # int32 (...,) argmax over the scan window
    rescaled_bin: jnp.ndarray   # int32 (...,) pre-pad-grid quantized bin
    distance_m: jnp.ndarray     # float32 (...,) reference distance formula
    peak_magnitude: jnp.ndarray  # float32 (...,) |X[peak]|


def scan_window_argmax(
    spectrum: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Argmax of |X| over the first ``scan_bins`` bins.

    Returns (peak_bin int32, peak_magnitude float32).
    """
    window = spectrum[..., : cfg.scan_bins]
    power = window.real * window.real + window.imag * window.imag
    idx = jnp.argmax(power, axis=-1).astype(jnp.int32)
    peak_power = jnp.take_along_axis(power, idx[..., None].astype(jnp.int32), axis=-1)
    return idx, jnp.sqrt(peak_power[..., 0])


def _rescale_bin_i32(peak_bin: jnp.ndarray, cfg: RadarConfig) -> jnp.ndarray:
    """Exact ``peak_bin * rx_samples // fft_size`` without int32 overflow.

    JAX defaults to int32 (no x64), and the direct product overflows once
    rx_samples exceeds ~51k (e.g. 256 samples x 512 chirps), silently
    flipping distances negative.  fft_size is a power of two, so split:

      rx_samples = q * fft + r  (q in {0,1} since fft = nextPow2(rx))
      peak_bin   = ph * 2^12 + pl
      (peak_bin * r) // 2^k
        = (ph*r >> (k-12)) + (((ph*r & (2^(k-12)-1)) << 12) + pl*r) >> k

    All partial products stay below 2^31 for fft_size up to 2^18.
    """
    fft = cfg.fft_size
    k = fft.bit_length() - 1
    q, r = divmod(cfg.rx_samples, fft)
    rescaled = peak_bin * q
    if r:
        if cfg.scan_bins * r < 2**31:
            rescaled = rescaled + (peak_bin * r) // fft
        else:
            if k <= 12 or k > 18:
                raise ValueError(
                    f"fft_size {fft} out of supported overflow-safe range"
                )
            ph = peak_bin >> 12
            pl = peak_bin & 0xFFF
            a = ph * r                      # < 2^(k-12) * 2^k <= 2^24
            low = ((a & ((1 << (k - 12)) - 1)) << 12) + pl * r  # < 2^31
            rescaled = rescaled + (a >> (k - 12)) + (low >> k)
    return rescaled


def distance_from_bin(
    peak_bin: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reference range math (acceleration.cu:521-523).

    rescaled = peak_bin * rx_samples // fft_size   (integer division)
    distance = c * ((rescaled / fft_size) * Fs_extend) / (2 mu)
    """
    rescaled = _rescale_bin_i32(peak_bin, cfg)
    scale = (
        LIGHT_SPEED
        * cfg.extended_sample_rate_hz
        / (cfg.fft_size * 2.0 * cfg.slope_hz_per_s)
    )
    return rescaled, rescaled.astype(jnp.float32) * jnp.float32(scale)


def peak_detect(
    spectrum: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> PeakDetection:
    """Full single-target detection from a range spectrum."""
    peak_bin, mag = scan_window_argmax(spectrum, cfg)
    rescaled, dist = distance_from_bin(peak_bin, cfg)
    return PeakDetection(peak_bin, rescaled, dist, mag)
