"""Mutual-FMCW-interference detection and blanking on the raw stream.

Another radar's sweep crossing ours produces short broadband bursts in
the ADC samples, orders of magnitude stronger than any target beat; a
handful of them per frame can blind the whole CFAR map (the burst's
energy smears across every range bin of its chirp).  The standard
first-line mitigation is amplitude blanking: detect the outlier samples
and zero them before the range DFT — an FMCW beat signal is
near-constant-modulus per chirp, so legitimate samples cluster tightly
around the frame's median magnitude while bursts sit far outside.

The op is a shorts -> shorts transform (int16 in, int16 out) so it
composes with EVERY pipeline implementation unchanged — including the
fused front-end, whose contract starts at the raw interleaved stream.  Zeroed samples are exactly representable, and the detector
threshold is RELATIVE (k^2 x the frame's median |x|^2), so on a clean
capture nothing is blanked: for complex noise the extreme |x|^2 over a
~51k-sample frame is ~ln(N) ~ 11x the mean ~ 16x the median — far
inside the default k=8 (64x) gate, while bursts 10x the signal sit
100x above it.

Exactness: |x|^2 <= 2 * 32767^2 = 2,147,352,578 fits int32 EXACTLY
(f32 would round above 2^24), the median is defined as the sorted
element at index n // 2 (the upper middle of the even count — an
integer), and the gate compares
the f32 casts of those exact integers — so the NumPy twin
(:func:`golden_blank_interference`) reproduces every blanking decision
bit-for-bit, not just approximately.

The reference has no interference story (no real radar deployment
skips one).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mmradar.config import RadarConfig, DEFAULT_CONFIG  # noqa: F401


@functools.partial(jax.jit, static_argnames=("k",))
def blank_interference(
    shorts: jnp.ndarray,
    k: float = 8.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Zero interference-burst samples in the raw int16 stream.

    Args:
      shorts: int16 (..., shorts_per_frame) on-disk-layout frames.
      k: amplitude threshold in units of the frame's median magnitude
        (a sample is blanked when |x|^2 > k^2 * median |x|^2; the
        median is the sorted element at index n // 2 — the upper
        middle of the always-even count).

    Returns:
      (blanked int16, n_blanked int32 (...,)) — blanked is bit-identical
      to the input wherever no sample crosses the gate.
    """
    lead = shorts.shape[:-1]
    g = shorts.reshape(lead + (-1, 4)).astype(jnp.int32)
    # (I0, I1, Q0, Q1) -> |c0|^2, |c1|^2 per 4-short group — exact int32
    m0 = g[..., 0] * g[..., 0] + g[..., 2] * g[..., 2]
    m1 = g[..., 1] * g[..., 1] + g[..., 3] * g[..., 3]
    m = jnp.concatenate([m0, m1], axis=-1)
    n = m.shape[-1]
    med = jnp.sort(m, axis=-1)[..., n // 2]   # exact int (upper middle)
    thr = jnp.float32(k * k) * med.astype(jnp.float32)[..., None]
    k0 = m0.astype(jnp.float32) <= thr
    k1 = m1.astype(jnp.float32) <= thr
    keep = jnp.stack([k0, k1, k0, k1], axis=-1)
    gi = shorts.reshape(lead + (-1, 4))
    out = jnp.where(keep, gi, jnp.int16(0)).reshape(shorts.shape)
    n_blanked = (
        jnp.sum(~k0, axis=-1) + jnp.sum(~k1, axis=-1)
    ).astype(jnp.int32)
    return out, n_blanked


def golden_blank_interference(
    shorts: np.ndarray, k: float = 8.0
) -> tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`blank_interference` — bit-identical output
    (same exact-int32 magnitudes, same index-n//2 median, same f32
    gate arithmetic)."""
    shorts = np.asarray(shorts)
    lead = shorts.shape[:-1]
    g = shorts.reshape(lead + (-1, 4)).astype(np.int32)
    m0 = g[..., 0] * g[..., 0] + g[..., 2] * g[..., 2]
    m1 = g[..., 1] * g[..., 1] + g[..., 3] * g[..., 3]
    m = np.concatenate([m0, m1], axis=-1)
    n = m.shape[-1]
    med = np.sort(m, axis=-1)[..., n // 2]
    thr = np.float32(k * k) * med.astype(np.float32)[..., None]
    k0 = m0.astype(np.float32) <= thr
    k1 = m1.astype(np.float32) <= thr
    keep = np.stack([k0, k1, k0, k1], axis=-1)
    gi = shorts.reshape(lead + (-1, 4))
    out = np.where(keep, gi, np.int16(0)).reshape(shorts.shape)
    n_blanked = ((~k0).sum(axis=-1) + (~k1).sum(axis=-1)).astype(np.int32)
    return out.astype(np.int16), n_blanked
