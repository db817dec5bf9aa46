"""Micro-Doppler spectrogram: slow-time STFT at a range gate, as matmuls.

The RD pipeline's per-frame Doppler FFT resolves bulk radial velocity;
modulations faster than a frame (rotor blades, gait, vibration) only
show up in a spectrogram of the CONTINUOUS slow-time signal across
frames.  This is the classic micro-Doppler product, absent from the
reference (its detector is a single per-frame argmax,
/root/reference/acceleration.cu:518-523) and a standard ask of any
radar framework.

Device mapping: the range gating reuses the fused range front-end
(``ops.fuseddft.fused_range_planes`` — decode + window + range DFT as
matmuls), the STFT is ONE planar matmul of the strided window
matrix against a window-folded DFT matrix (``ops.dftmat.dft_matrix``
already supports folding the window taps and the fftshift into the
constant), and the whole program jits end-to-end.  This is an offline
analysis product, not the serving hot path — the XLA formulation is the
right cost/clarity point (one gather + one matmul).

Numerics: float64 golden twin in ``golden.micro_doppler``; parity is
gated at the cfg.dft_precision class in tests/test_mdoppler.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG
from mmradar.golden import micro_doppler_velocity_axis  # noqa: F401  (re-export)
from mmradar.ops.dftmat import dft_matrix, resolve_precision
from mmradar.ops.fuseddft import fused_range_planes
from mmradar.ops.window import resolve_window


@functools.partial(jax.jit, static_argnames=("cfg", "window"))
def _range_gate_power(shorts, base_cube, cfg, window):
    rng_re, rng_im = fused_range_planes(shorts, base_cube, cfg, window)
    return jnp.sum(rng_re * rng_re + rng_im * rng_im,
                   axis=tuple(range(rng_re.ndim - 1)))


def auto_range_bin(
    shorts: jnp.ndarray,
    base_cube: jnp.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool | str = True,
) -> int:
    """Strongest range gate over the capture: argmax of clutter-removed
    range power integrated over frames, chirps and RX (a concrete int —
    host sync, once, before the jitted spectrogram).  The reduction runs
    as a jitted program and the tiny (R,) f32 vector is fetched in one
    transfer; the argmax happens on the host."""
    import numpy as np

    p = np.asarray(_range_gate_power(shorts, base_cube, cfg, window))
    return int(np.argmax(p))


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "range_bin", "win_frames", "hop_frames",
                     "n_fft", "window"),
)
def micro_doppler_spectrogram(
    shorts: jnp.ndarray,
    base_cube: jnp.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    range_bin: int = 0,
    win_frames: int = 8,
    hop_frames: int = 1,
    n_fft: int | None = None,
    window: bool | str = True,
) -> jnp.ndarray:
    """Raw int16 frames -> (n_windows, n_fft) micro-Doppler power.

    Mirrors ``golden.micro_doppler`` exactly: windowed range DFT +
    clutter removal (base planes or per-frame chirp mean), gate at
    ``range_bin``, TX0 chirps (uniform PRI under TDM), RX mean, then an
    STFT whose window taps and fftshift are folded into the DFT-matrix
    constant.  Doppler axis fftshifted; velocities per bin from
    :func:`golden.micro_doppler_velocity_axis`.
    """
    kind = resolve_window(window, cfg)
    kc = cfg.chirps_per_tx
    length = win_frames * kc
    hop = hop_frames * kc
    if n_fft is None:
        n_fft = length
    if n_fft < length:
        raise ValueError(
            f"n_fft ({n_fft}) must be >= the window length ({length}): "
            "the STFT zero-pads, it does not truncate windowed segments "
            "(a window-folded DFT matrix would time-alias instead — the "
            "same hazard ops/aoa.angle_fft_spectrum documents)"
        )
    rng_re, rng_im = fused_range_planes(shorts, base_cube, cfg, window)
    # gate + TX0 + RX mean: (n, C, V, R) -> (n * Kc,) planar series
    g_re = rng_re[..., range_bin][:, 0 :: cfg.num_tx, :].mean(-1).reshape(-1)
    g_im = rng_im[..., range_bin][:, 0 :: cfg.num_tx, :].mean(-1).reshape(-1)
    if g_re.shape[0] < length:
        raise ValueError(
            f"capture too short: {g_re.shape[0]} slow-time samples < "
            f"window {length} ({win_frames} frames x {kc})"
        )
    n_win = (g_re.shape[0] - length) // hop + 1
    idx = (jnp.arange(n_win) * hop)[:, None] + jnp.arange(length)[None, :]
    xw_re = g_re[idx]                              # (n_win, L)
    xw_im = g_im[idx]
    m = dft_matrix(length, n_fft, kind if kind else False, shift=True)
    mr = jnp.real(m).T                             # (L, n_fft)
    mi = jnp.imag(m).T
    prec = resolve_precision(cfg.dft_precision)
    dot = functools.partial(jnp.matmul, precision=prec)
    s_re = dot(xw_re, mr) - dot(xw_im, mi)
    s_im = dot(xw_re, mi) + dot(xw_im, mr)
    return s_re * s_re + s_im * s_im
