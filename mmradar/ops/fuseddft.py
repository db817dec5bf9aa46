"""Fused decode + window + range-Doppler DFT as interleave-aware matmuls.

The hot-path insight: the expensive part of the pipeline is not the DFT
FLOPs but the *layout* work in front of them — de-interleaving the TI
4-lane ``(I0, I1, Q0, Q1)`` shorts (reference kernel K1,
acceleration.cu:91-110) and the chirp-major -> RX-major transpose (K2,
acceleration.cu:117-150) each materialize the full cube in device memory.
Both are *linear* maps, so they fold INTO the DFT matrices:

* **De-interleave**: the windowed range DFT over complex samples
  ``x_t = I_t + i Q_t`` is rewritten as one real matmul pair over the raw
  interleaved short axis (length 2S).  Column ``j`` of the (R, 2S) matrix
  carries ``w_t cos/sin`` at the interleave position of ``I_t``/``Q_t``:

      X_re[r] = sum_t w_t (I_t cos θ_rt + Q_t sin θ_rt)
      X_im[r] = sum_t w_t (Q_t cos θ_rt - I_t sin θ_rt),  θ = 2π r t / R

  so the int16 -> f32 convert feeds the matmul directly; no decoded cube,
  no de-interleave pass, no transpose ever reaches device memory.
* **Transpose**: the chirp/RX axis order is fixed in the einsum output
  specs — the contraction itself produces RX-major results.
* **Clutter removal**: the range transform is linear, so base-frame
  subtraction happens AFTER it, on the (C, V, R) transformed base (one
  frame's worth, computed once per jit trace) instead of on every raw
  frame.

Everything stays one fused XLA program (``rd_impl='fused'``); its speed
on the card beside the other front-ends is in PERF.md.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from mmradar.config import RadarConfig, DEFAULT_CONFIG
from mmradar.golden import window_fn
from mmradar.ops.dftmat import _cmatmul_planar, dft_matrix, resolve_precision
from mmradar.ops.window import resolve_window


@lru_cache(maxsize=16)
def _interleaved_range_factors(
    n_samples: int, n_fft: int, windowed
) -> tuple[np.ndarray, np.ndarray]:
    """(A_re, A_im), each (n_fft, 2*n_samples) f32: windowed range DFT that
    consumes the raw ``(I0, I1, Q0, Q1)`` interleaved short vector.
    ``windowed``: False | True (hann) | window-kind string."""
    if n_samples % 2:
        raise ValueError("interleaved decode needs an even sample count")
    r = np.arange(n_fft)[:, None]
    t = np.arange(n_samples)[None, :]
    theta = 2.0 * np.pi * r * t / n_fft
    w = (window_fn(n_samples, "hann" if windowed is True else windowed)[None, :]
         if windowed else np.ones((1, n_samples)))
    cos, sin = np.cos(theta) * w, np.sin(theta) * w
    # interleave position of I_t / Q_t within the 4-short groups
    ti = np.arange(n_samples)
    i_col = 4 * (ti // 2) + (ti % 2)
    q_col = i_col + 2
    a_re = np.zeros((n_fft, 2 * n_samples))
    a_im = np.zeros((n_fft, 2 * n_samples))
    a_re[:, i_col] = cos
    a_re[:, q_col] = sin
    a_im[:, i_col] = -sin
    a_im[:, q_col] = cos
    return a_re.astype(np.float32), a_im.astype(np.float32)


def interleaved_range_matrices(
    n_samples: int, n_fft: int, windowed=True
) -> tuple[jnp.ndarray, jnp.ndarray]:
    a_re, a_im = _interleaved_range_factors(n_samples, n_fft, windowed)
    return jnp.asarray(a_re), jnp.asarray(a_im)


def _base_range_planes(base_cube, cfg: RadarConfig, window):
    """Windowed range transform of the base cube, laid out (C, V, R) to
    match the fused path's post-range orientation."""
    f_rng = dft_matrix(base_cube.shape[-1], cfg.range_fft_size,
                       resolve_window(window, cfg))
    return _cmatmul_planar(
        base_cube.real, base_cube.imag, f_rng.real, f_rng.imag,
        "vcs,rs->cvr", resolve_precision(cfg.dft_precision),
    )


def base_raw_interleave(base_cube, cfg: RadarConfig) -> jnp.ndarray:
    """(C, V, 2S) f32: the base cube back in the raw ``(I0, I1, Q0, Q1)``
    interleave (the inverse of ``decode.decode_to_cube``'s 4-lane demux,
    exact — the cube holds f32-exact int16 values).

    Base-frame clutter removal subtracts this from the raw frames BEFORE
    the range DFT: the windowed DFT is linear, so
    ``(raw - base_raw) @ A == raw @ A - base_z`` in exact arithmetic —
    one (C*V, 2S) subtract on the cast chain instead of two (C*V, R)
    plane subtracts after the dot (2.5x fewer elementwise cells at the
    default geometry), and every raw-space range path (fused, the
    distributed fused shard) shares ONE subtraction convention."""
    import numpy as np

    # shapes from the cube itself: distributed shards pass an RX-sliced
    # base (rx_local, C, S) and get the matching (C, rx_local, 2S) back
    v, c, s = base_cube.shape
    t = np.arange(s)
    i_col = 4 * (t // 2) + (t % 2)
    bc = jnp.swapaxes(base_cube, 0, 1)           # (chirps, rx, samples)
    bs = jnp.zeros((c, v, 2 * s), jnp.float32)
    bs = bs.at[..., i_col].set(jnp.real(bc).astype(jnp.float32))
    bs = bs.at[..., i_col + 2].set(jnp.imag(bc).astype(jnp.float32))
    return bs


def fused_range_planes(
    shorts: jnp.ndarray,
    base_cube: jnp.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw int16 frames -> clutter-removed range planes (..., C, V, R).

    The range front-end of :func:`fused_rd_planes`, exposed separately
    for stage-level verification and the micro-Doppler gate.
    """
    window = resolve_window(window, cfg)
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    raw = shorts.reshape(shorts.shape[:-1] + (c, v, s2)).astype(jnp.float32)
    mode = cfg.effective_clutter(base_cube is not None)
    if mode == "base":
        # raw-space base subtraction (see base_raw_interleave): exact
        raw = raw - base_raw_interleave(base_cube, cfg)
    a_re, a_im = interleaved_range_matrices(
        cfg.num_samples, cfg.range_fft_size, window
    )
    prec = resolve_precision(cfg.dft_precision)
    # range DFT straight off the interleaved axis: (..., C, V, 2S) @ (R, 2S)
    rng_re = jnp.einsum("...cvj,rj->...cvr", raw, a_re, precision=prec)
    rng_im = jnp.einsum("...cvj,rj->...cvr", raw, a_im, precision=prec)
    if mode == "base":
        return rng_re, rng_im
    from mmradar.ops.preproc import declutter_planes

    # mti2/mti3 are linear along the chirp axis, so filtering the range
    # planes equals filtering the raw cube (golden.mti_filter)
    return declutter_planes(rng_re, rng_im, mode, None,
                            axis=-3, stride=cfg.num_tx)


def fused_rd_planes(
    shorts: jnp.ndarray,
    base_cube: jnp.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw int16 frames -> range-Doppler planes, fully fused.

    Args:
      shorts: int16 (B, shorts_per_frame) in on-disk layout.
      base_cube: complex64 (rx, chirps, samples) empty-scene cube, or None
        for mean-over-chirps clutter removal (linear, so applying it to the
        range-transformed planes is exactly equivalent).

    Returns:
      (dr, di) float32 (B, num_virtual_rx, doppler_fft, range_fft),
      Doppler fftshifted — identical contract to
      ``dftmat.range_doppler_planes`` after virtualization.
    """
    rng_re, rng_im = fused_range_planes(shorts, base_cube, cfg, window)
    return doppler_from_range_planes(rng_re, rng_im, cfg, window)


def doppler_from_range_planes(
    rng_re: jnp.ndarray,
    rng_im: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(B, C, V, R) clutter-removed range planes -> (B, TX*V, D, R) RD
    planes: TDM de-multiplex (a reshape of the chirp axis into (K, TX)
    groups) + Doppler DFT + RX-major output order, all in one contraction.
    """
    v = rng_re.shape[-2]
    tx = cfg.num_tx
    k = cfg.chirps_per_tx
    lead = rng_re.shape[:-3]
    shape = lead + (k, tx, v, cfg.range_fft_size)
    rng_re = rng_re.reshape(shape)
    rng_im = rng_im.reshape(shape)

    f_dop = dft_matrix(k, cfg.doppler_fft_size, resolve_window(window, cfg),
                       shift=True)
    # (D, K) x (..., K, TX, V, R) -> (..., TX, V, D, R)
    dr, di = _cmatmul_planar(
        f_dop.real, f_dop.imag, rng_re, rng_im, "dk,...ktvr->...tvdr",
        resolve_precision(cfg.dft_precision),
    )
    out = lead + (tx * v, cfg.doppler_fft_size, cfg.range_fft_size)
    return dr.reshape(out), di.reshape(out)
