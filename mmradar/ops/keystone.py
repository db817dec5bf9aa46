"""Keystone transform: exact range-migration compensation on raw data.

Within one CPI a mover's beat frequency drifts — the dechirped phase is

    phi(n, m) = (4*pi/c) * (f_c + S*t_n) * (R0 + v*t_m)        (up to
                the constant 2*f_c*R0/c the generator also drops)

so the range peak walks ``v * CPI / r_res`` cells across the chirps and
the Doppler FFT smears it over both axes once that exceeds one cell.
The map-level ``--walk`` alignment (rd_pipeline.detect_integrated)
shifts whole maps BETWEEN frames; the keystone transform removes the
coupling exactly WITHIN the CPI, for every velocity at once, by
rescaling slow time per fast-time sample:

    t' = t * (f_c + S*t_n) / f_c        <=>   evaluate s at  t = alpha_n * t',
    alpha_n = f_c / (f_c + S*t_n)

after which phi = (4*pi/c) * (S*t_n*R0 + f_c*v*t') — range and Doppler
separate cleanly.  The resampling is the standard DFT-based form (exact
for band-limited slow-time content): per fast-time sample n, the
slow-time spectrum is re-evaluated at scaled positions with one
(D, D) matrix — a batched matmul over the sample axis, not a
gather/interpolation loop.

TDM-MIMO: each virtual channel's stream samples absolute slow time at
``(m*num_tx + tx) * Tc``, so the scaled evaluation point in STREAM
coordinates is ``alpha_n*m + (alpha_n - 1)*tx/num_tx`` — the per-TX
fractional offset is folded into the per-TX matrix stack.

Caveats (standard for keystone): the signed-frequency mapping assumes
the true Doppler is UNAMBIGUOUS — aliased velocities are rescaled by the
wrong factor and stay smeared (ambiguity-number hypotheses would extend
it); slow-time content is treated as periodic, so off-grid Doppler
tones pick up spectral-leakage-level interpolation error.

Reference contrast: the reference has no motion compensation at all —
one range FFT per frame (acceleration.cu:522); migration within its
8.2 ms CPI is sub-cell at its geometry, which is exactly why this ships
as an opt-in for long-CPI / fine-range-resolution configs.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG


def keystone_matrices(cfg: RadarConfig) -> np.ndarray:
    """(num_tx, num_samples, D, D) complex64 resampling stack, host-side.

    ``K[tx, n] @ FFT(s)`` evaluates the slow-time inverse DFT of one
    stream at the keystone-scaled positions for fast-time sample n.

    f64-phase reference twin of the matrices :func:`keystone_cube` now
    builds ON DEVICE chunk-by-chunk (this full stack is ~210 MB complex64
    at 512 chirps — fine as an inspectable host array, wrong as a jit
    constant, which is why the production path no longer consumes it).
    """
    d = cfg.num_chirps // cfg.num_tx
    t_n = np.arange(cfg.num_samples, dtype=np.float64) / cfg.sample_rate_hz
    alpha = cfg.carrier_hz / (cfg.carrier_hz + cfg.slope_hz_per_s * t_n)
    k = np.arange(d)
    k_signed = np.where(k < (d + 1) // 2, k, k - d).astype(np.float64)
    m = np.arange(d, dtype=np.float64)
    out = np.empty((cfg.num_tx, cfg.num_samples, d, d), np.complex64)
    for tx in range(cfg.num_tx):
        # stream-coordinate evaluation points: alpha*m + (alpha-1)*tx/ntx
        pos = (alpha[:, None] * m[None, :]
               + (alpha - 1.0)[:, None] * (tx / cfg.num_tx))  # (N, D)
        out[tx] = (np.exp(2j * np.pi / d
                          * pos[:, :, None] * k_signed[None, None, :])
                   / d)
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "chunk"))
def keystone_cube(
    cube: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG,
    chunk: int = 8,
) -> jnp.ndarray:
    """Apply the keystone transform to a VIRTUALIZED radar cube.

    The resampling matrices are computed ON DEVICE inside a
    ``lax.scan`` over fast-time chunks — only ``(T, chunk, D, D)``
    complex lives at once — instead of embedding the full
    ``(T, N, D, D)`` stack as a jit constant (~210 MB complex64 at 512
    chirps, >800 MB at 1024: a round-4 review catch for a feature aimed
    at exactly the long-CPI configs that blow it up).  The on-device
    phase runs in f32: the largest phase argument is ``2*pi*D`` rad, so
    rounding is ~5e-5 relative at D = 128 and ~2e-4 at D = 512 — inside
    the parity tests' 2e-4 gate and two orders under the f64 golden's
    use as truth (``golden.keystone_transform`` keeps full f64).

    Args:
      cube: complex64 (..., V, D, N) — virtual channels, chirps-per-TX,
        fast-time samples (``virtualize_cube`` layout; with num_tx == 1
        this is the decoded (..., rx, chirps, samples) cube directly).
      chunk: fast-time samples per scan step (memory knob; any value
        >= 1 gives identical results).

    Returns:
      same shape/dtype, slow time rescaled so range-Doppler coupling
      vanishes for unambiguous velocities (see module docstring).
    """
    if cube.shape[-3] != cfg.num_virtual_rx:
        raise ValueError(
            f"keystone_cube wants a virtualized cube with "
            f"{cfg.num_virtual_rx} channels, got {cube.shape[-3]} "
            "(run virtualize_cube first)"
        )
    lead = cube.shape[:-3]
    d, n = cube.shape[-2], cube.shape[-1]
    x = cube.reshape((-1, cfg.num_tx, cfg.num_rx, d, n))
    spec = jnp.fft.fft(x, axis=-2)  # per-stream slow-time spectrum

    # small host-side vectors (f64 where it matters: alpha is a ratio
    # of ~77 GHz quantities, computed in f64 then carried as f32)
    t_n = np.arange(n, dtype=np.float64) / cfg.sample_rate_hz
    alpha = cfg.carrier_hz / (cfg.carrier_hz + cfg.slope_hz_per_s * t_n)
    k = np.arange(d)
    k_signed = jnp.asarray(
        np.where(k < (d + 1) // 2, k, k - d), jnp.float32
    )
    m = jnp.asarray(np.arange(d), jnp.float32)
    tx_off = jnp.asarray(
        np.arange(cfg.num_tx, dtype=np.float64) / cfg.num_tx, jnp.float32
    )

    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk
    alpha_c = jnp.asarray(
        np.pad(alpha, (0, n_pad - n), constant_values=1.0), jnp.float32
    ).reshape(n_chunks, chunk)
    spec_p = jnp.pad(spec, ((0, 0),) * 4 + ((0, n_pad - n),))
    b = spec_p.shape[0]
    # (n_chunks, b, T, R, D, chunk)
    spec_c = jnp.moveaxis(
        spec_p.reshape(b, cfg.num_tx, cfg.num_rx, d, n_chunks, chunk),
        -2, 0,
    )

    def step(_, operand):
        al, sp = operand       # (chunk,), (b, T, R, D, chunk)
        # stream-coordinate evaluation points per TX:
        # pos[t, c, m'] = alpha_c*m' + (alpha_c - 1)*tx/ntx
        pos = (al[None, :, None] * m[None, None, :]
               + (al - 1.0)[None, :, None] * tx_off[:, None, None])
        theta = (2.0 * np.pi / d) * pos[..., None] * k_signed
        km = jax.lax.complex(jnp.cos(theta), jnp.sin(theta)) / d
        out = jnp.einsum("tcmk,btrkc->btrmc", km, sp,
                         precision=jax.lax.Precision.HIGHEST)
        return _, out

    _, outs = jax.lax.scan(step, 0, (alpha_c, spec_c))
    # (n_chunks, b, T, R, D, chunk) -> (b, T, R, D, n)
    out = jnp.moveaxis(outs, 0, -2).reshape(
        (b, cfg.num_tx, cfg.num_rx, d, n_pad)
    )[..., :n]
    return out.reshape(lead + (cfg.num_virtual_rx, d, n)).astype(cube.dtype)
