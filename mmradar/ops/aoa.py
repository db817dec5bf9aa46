"""Angle-of-arrival estimation (device path).

Two estimators over the (virtual) RX array, matching the golden model:

* ``angle_fft_spectrum`` — zero-padded FFT across the RX axis; cheap, used
  per detected cell.
* ``capon_spectrum`` — MVDR beamformer: P(theta) = 1 / (a^H R^{-1} a) with
  diagonal loading.  The spatial covariance and the steering-vector
  quadratic form are small dense matmuls and batch over
  detections/range bins.

The reference has no angle stage (its ``d = lambda/2`` array constant at
cudaBenchMarking.cpp:19 is declared but unused); contracts are defined by
``mmradar.golden``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mmradar.config import RadarConfig, DEFAULT_CONFIG


@functools.lru_cache(maxsize=None)
def _angle_dft_rows(n_rx: int, n_bins: int) -> np.ndarray:
    """(n_rx, n_bins) zero-padded-DFT rows, pre-fftshifted."""
    w = np.exp(
        -2j * np.pi * np.outer(np.arange(n_rx), np.arange(n_bins)) / n_bins
    )
    return np.fft.fftshift(w, axes=-1).astype(np.complex64)


def angle_fft_spectrum(
    rx_snapshot: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> jnp.ndarray:
    """Angle spectrum via zero-padded FFT across the RX axis.

    Computed as an explicit sum of n_rx broadcast outer products rather
    than an FFT HLO or a matmul: the input has only a handful of virtual
    elements, too few for a matmul or a batched small FFT to pay for
    itself (identical angle bins either way).

    Args:
      rx_snapshot: complex64 (..., n_rx) cell values.

    Returns:
      complex64 (..., num_angle_bins), fftshifted.
    """
    n = cfg.num_angle_bins
    # fft(x, n=...) TRUNCATES inputs longer than n (matching the golden
    # twin); summing past n would alias element i onto row i mod n
    v = min(rx_snapshot.shape[-1], n)
    w = _angle_dft_rows(v, n)
    return sum(
        rx_snapshot[..., i : i + 1] * jnp.asarray(w[i]) for i in range(v)
    )


def disambiguate_velocity(
    snaps: jnp.ndarray,
    d_bin: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """TDM Doppler-ambiguity hypothesis test (twin of
    ``golden.disambiguate_velocity`` — see its docstring for the math).

    The ``num_tx`` hypotheses are a tiny static unroll (2-4 in
    practice); each one is a per-snapshot phase ramp + the angle
    spectrum already used for azimuth, so the whole test is a few
    KB-sized VPU ops per detection batch.

    Args:
      snaps: complex64 (..., K, V) UNCOMPENSATED virtual snapshots.
      d_bin: int32 (..., K) fftshifted Doppler bin.

    Returns:
      (velocity_mps, hypothesis, snaps_comp): float32 (..., K) true
      radial velocity over the extended span, int32 (..., K) winning
      hypothesis, complex64 (..., K, V) the winner's compensated
      snapshots (feed to the angle estimators).
    """
    d = cfg.doppler_fft_size
    ts = cfg.slow_time_interval_s
    fd0 = (d_bin - d // 2).astype(jnp.float32) / jnp.float32(d * ts)
    if cfg.num_tx == 1:
        return (fd0 * jnp.float32(cfg.wavelength_m / 2.0),
                jnp.zeros_like(d_bin), snaps)
    v = snaps.shape[-1]
    tx_idx = (jnp.arange(v) // cfg.num_rx).astype(jnp.float32)
    best_score = jnp.full(fd0.shape, -jnp.inf, jnp.float32)
    best_h = jnp.zeros(d_bin.shape, jnp.int32)
    best_fd = fd0
    best_snaps = snaps
    for h in range(cfg.num_tx):
        fd_h = fd0 + jnp.float32(h / ts)
        phase = (-2.0 * jnp.pi * cfg.chirp_interval_s) * fd_h[..., None] * tx_idx
        comp = snaps * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
        spec = angle_fft_spectrum(comp, cfg)
        score = jnp.max(jnp.abs(spec) ** 2, axis=-1).astype(jnp.float32)
        take = score > best_score
        best_score = jnp.where(take, score, best_score)
        best_h = jnp.where(take, jnp.int32(h), best_h)
        best_fd = jnp.where(take, fd_h, best_fd)
        best_snaps = jnp.where(take[..., None], comp, best_snaps)
    lim = jnp.float32(1.0 / (2.0 * cfg.chirp_interval_s))
    best_fd = jnp.mod(best_fd + lim, 2.0 * lim) - lim
    return (best_fd * jnp.float32(cfg.wavelength_m / 2.0),
            best_h, best_snaps)


def angle_bins_deg(cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Degrees for each (fftshifted) angle-FFT bin."""
    n = cfg.num_angle_bins
    sin_theta = (np.arange(n) - n // 2) / (n * cfg.rx_spacing_wavelengths)
    return np.rad2deg(np.arcsin(np.clip(sin_theta, -1.0, 1.0)))


def _steering_matrix(n_rx: int, cfg: RadarConfig) -> np.ndarray:
    lo, hi, n = cfg.angle_grid_deg
    angles = np.linspace(lo, hi, int(n))
    k = 2.0 * np.pi * cfg.rx_spacing_wavelengths
    return angles, np.exp(
        1j * k * np.sin(np.deg2rad(angles))[:, None] * np.arange(n_rx)[None, :]
    ).astype(np.complex64)


def capon_aoa_at_cells(
    range_cube: jnp.ndarray,
    d_bin: jnp.ndarray,
    r_bin: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    diagonal_loading: float = 1e-3,
) -> jnp.ndarray:
    """Capon azimuth per detected cell, from chirp-domain snapshots.

    Args:
      range_cube: complex64 (B, V, chirps_per_tx, R) — range FFT per
        virtual channel, BEFORE the Doppler FFT (the chirp axis provides
        the snapshots for the covariance estimate).
      d_bin: int32 (B, K) fftshifted Doppler bin (for TDM compensation).
      r_bin: int32 (B, K) range bin of each detection.

    Returns:
      float32 (B, K) azimuth in degrees.
    """
    v = range_cube.shape[1]
    # gather snapshots at each detection's range bin: (B, K, CPT, V)
    snaps = jnp.take_along_axis(
        range_cube[:, None],  # (B, 1, V, CPT, R)
        r_bin[:, :, None, None, None],  # (B, K, 1, 1, 1)
        axis=-1,
    )[..., 0]  # (B, K, V, CPT)
    snaps = jnp.swapaxes(snaps, -2, -1)  # (B, K, CPT, V)

    if cfg.num_tx > 1:
        # constant TDM phase between TX groups: e^{j 2 pi fd tx Tr}
        d = cfg.doppler_fft_size
        fd = (d_bin - d // 2).astype(jnp.float32) / jnp.float32(
            d * cfg.slow_time_interval_s
        )
        tx_idx = (jnp.arange(v) // cfg.num_rx).astype(jnp.float32)
        phase = (-2.0 * jnp.pi * cfg.chirp_interval_s) * fd[..., None] * tx_idx
        rot = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
        snaps = snaps * rot[..., None, :]

    _, power = capon_spectrum(snaps, cfg, diagonal_loading)
    angles = jnp.asarray(
        np.linspace(*cfg.angle_grid_deg[:2], int(cfg.angle_grid_deg[2])),
        jnp.float32,
    )
    return angles[jnp.argmax(power, axis=-1)]


def _steering_grid_2d(cfg: RadarConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(az_deg, el_deg, conj-steering (n_az, n_el, V) c64) for the planar
    virtual array (twin of the scan in golden.aoa_2d)."""
    pos = cfg.virtual_positions_wl()
    az = np.linspace(*cfg.angle_grid_deg[:2], int(cfg.angle_grid_deg[2]))
    el = np.linspace(
        *cfg.elevation_grid_deg[:2], int(cfg.elevation_grid_deg[2])
    )
    saz, cel = np.sin(np.deg2rad(az)), np.cos(np.deg2rad(el))
    sel = np.sin(np.deg2rad(el))
    phase = 2 * np.pi * (
        pos[None, None, :, 0] * saz[:, None, None] * cel[None, :, None]
        + pos[None, None, :, 1] * sel[None, :, None]
    )
    return az, el, np.exp(-1j * phase).astype(np.complex64)


def aoa_2d_from_snapshots(
    snaps: jnp.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Joint (azimuth, elevation) per detection from planar-array
    snapshots (matched-filter grid scan; twin of golden.aoa_2d).

    The reference has no angle stage at all; elevation needs an elevated
    TX (``cfg.tx_positions_wl``) so the TDM virtual array spans two axes.

    Args:
      snaps: complex64 (..., K, V), TDM-compensated.

    Returns:
      (azimuth_deg, elevation_deg) float32 (..., K).
    """
    az, el, steer = _steering_grid_2d(cfg)
    n_el = el.shape[0]
    # chunk the azimuth axis so only a (.., K, chunk*n_el) slab of the
    # spectrum is live at once: the full (.., K, 181, 61) complex grid is
    # ~720 MB on a 512-frame serving batch.  Chunking the MAJOR axis of
    # the az*n_el flat index with a strict > running max reproduces the
    # global argmax's first-occurrence tie-breaking exactly.
    az_chunk = 24
    best_p = best_i = None
    for s in range(0, steer.shape[0], az_chunk):
        a = jnp.asarray(steer[s : s + az_chunk])  # (chunk, n_el, V)
        spec = jnp.einsum("aev,...kv->...kae", a, snaps)
        p = spec.real * spec.real + spec.imag * spec.imag
        flat = p.reshape(p.shape[:-2] + (-1,))
        pm = jnp.max(flat, axis=-1)
        pi = jnp.argmax(flat, axis=-1) + s * n_el
        if best_p is None:
            best_p, best_i = pm, pi
        else:
            take = pm > best_p
            best_i = jnp.where(take, pi, best_i)
            best_p = jnp.where(take, pm, best_p)
    az_t = jnp.asarray(az, jnp.float32)
    el_t = jnp.asarray(el, jnp.float32)
    return az_t[best_i // n_el], el_t[best_i % n_el]


def music_spectrum(
    snapshots: jnp.ndarray,
    num_sources: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[np.ndarray, jnp.ndarray]:
    """MUSIC pseudospectrum (device twin of golden.music_spectrum).

    The covariance and noise-subspace projection are small batched
    matmuls; the eigendecomposition of the (n_rx, n_rx) covariance
    is a batched ``eigh`` — tiny matrices, so XLA's QR iteration is cheap.

    Args:
      snapshots: complex64 (..., n_snapshots, n_rx).
      num_sources: assumed signal-subspace dimension (< n_rx).
    """
    x = snapshots
    n_rx = x.shape[-1]
    if not 0 < num_sources < n_rx:
        raise ValueError(f"num_sources must be in (0, {n_rx})")
    r = jnp.einsum("...si,...sj->...ij", x, x.conj(),
                   precision=jax.lax.Precision.HIGHEST) / x.shape[-2]
    _, vecs = jnp.linalg.eigh(r)  # ascending eigenvalues
    noise = vecs[..., :, : n_rx - num_sources]
    angles, steering = _steering_matrix(n_rx, cfg)
    a = jnp.asarray(steering)
    proj = jnp.einsum("...ij,aj->...ai", jnp.swapaxes(noise, -2, -1).conj(),
                      a, precision=jax.lax.Precision.HIGHEST)
    denom = jnp.sum(proj.real * proj.real + proj.imag * proj.imag, axis=-1)
    return angles, 1.0 / jnp.maximum(denom, 1e-30)


def capon_spectrum(
    snapshots: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    diagonal_loading: float = 1e-3,
) -> tuple[np.ndarray, jnp.ndarray]:
    """Capon/MVDR angle spectrum.

    Args:
      snapshots: complex64 (..., n_snapshots, n_rx).

    Returns:
      (angles_deg np.ndarray (n_angles,), power jnp (..., n_angles)).
    """
    x = snapshots
    n_rx = x.shape[-1]
    n_snap = x.shape[-2]
    # HIGHEST precision throughout: these contractions are tiny (n_rx is
    # 4-8) but MVDR is ill-conditioned by design — a reduced-precision
    # default dot (e.g. TF32) puts ~1e-3 relative error into R, which the
    # loaded inverse amplifies into a wrong spectrum; the f64 golden and
    # full-f32 contractions agree
    hi = jax.lax.Precision.HIGHEST
    r = jnp.einsum("...si,...sj->...ij", x, x.conj(), precision=hi) / n_snap
    tr = jnp.trace(r, axis1=-2, axis2=-1).real / n_rx
    eye = jnp.eye(n_rx, dtype=r.dtype)
    r = r + (diagonal_loading * tr)[..., None, None] * eye
    r_inv = jnp.linalg.inv(r)
    angles, steering = _steering_matrix(n_rx, cfg)
    a = jnp.asarray(steering)  # (n_angles, n_rx)
    denom = jnp.einsum("ai,...ij,aj->...a", a.conj(), r_inv, a,
                       precision=hi).real
    return angles, 1.0 / jnp.maximum(denom, 1e-30)


@functools.partial(jax.jit, static_argnames=("cfg", "window"))
def range_azimuth_from_shorts(
    shorts: jnp.ndarray,
    base_cube: jnp.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> jnp.ndarray:
    """Raw int16 frames -> range-azimuth power maps, fully fused.

    The scene-level heatmap counterpart of the per-detection AoA path:
    RD planes per virtual element (``fused_rd_planes`` — decode, window,
    range+Doppler DFTs as matmuls), per-Doppler-row TDM MIMO
    compensation, zero-padded angle DFT at EVERY (doppler, range) cell
    as one planar matmul over the virtual axis, noncoherent Doppler
    integration.  float64 twin: ``golden.range_azimuth_map``.

    Unlike the K-cell ``angle_fft_spectrum`` (where broadcast outer
    products over K=4 elements win), here the contraction is batched
    over B*D*R cells — a matmul shape.

    Returns:
      float32 (..., num_angle_bins, range_fft), angle axis fftshifted
      (``golden.angle_bin_to_deg`` maps bins to degrees).
    """
    from mmradar.ops.dftmat import resolve_precision

    cr, ci = _tdm_compensated_rd(shorts, base_cube, cfg, window)
    a = cfg.num_angle_bins
    v = min(cfg.num_virtual_rx, a)
    w = _angle_dft_rows(v, a)                               # (v, A) c64
    wr = jnp.real(w)
    wi = jnp.imag(w)
    prec = resolve_precision(cfg.dft_precision)
    ein = functools.partial(jnp.einsum, "va,...vdr->...adr",
                            precision=prec)
    sr = ein(wr, cr[..., :v, :, :]) - ein(wi, ci[..., :v, :, :])
    si = ein(wr, ci[..., :v, :, :]) + ein(wi, cr[..., :v, :, :])
    return (sr * sr + si * si).sum(axis=-2)

@functools.partial(
    jax.jit, static_argnames=("cfg", "range_bin", "window")
)
def angle_doppler_from_shorts(
    shorts: jnp.ndarray,
    base_cube: jnp.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    range_bin: int = 0,
    window: bool = True,
) -> jnp.ndarray:
    """Raw int16 frames -> angle-Doppler power map at one range gate.

    The third scene product (with the RD map and the range-azimuth map):
    movers separate by velocity AND bearing, so targets that collide in
    the range-azimuth view split here.  Same fused front-end,
    per-Doppler-row TDM compensation and calibration fold as
    :func:`range_azimuth_from_shorts`; the gate slice makes the angle
    DFT a tiny (D, v) x (v, A) contraction per frame.  float64 twin:
    ``golden.angle_doppler_map``.  Resolve an 'auto' gate with
    ``ops.mdoppler.auto_range_bin`` (a concrete int — static here).

    Returns:
      float32 (..., doppler_fft, num_angle_bins), angle axis fftshifted.
    """
    from mmradar.ops.dftmat import resolve_precision

    cr, ci = _tdm_compensated_rd(shorts, base_cube, cfg, window)
    a = cfg.num_angle_bins
    v = min(cfg.num_virtual_rx, a)
    w = _angle_dft_rows(v, a)                               # (v, A) c64
    wr = jnp.asarray(np.real(w))
    wi = jnp.asarray(np.imag(w))
    prec = resolve_precision(cfg.dft_precision)
    xr = cr[..., :v, :, range_bin]                          # (..., v, D)
    xi = ci[..., :v, :, range_bin]
    ein = functools.partial(jnp.einsum, "...vd,va->...da", precision=prec)
    sr = ein(xr, wr) - ein(xi, wi)
    si = ein(xr, wi) + ein(xi, wr)
    return sr * sr + si * si


def _tdm_compensated_rd(shorts, base_cube, cfg, window):
    """(..., V', D, R) planar RD planes with the per-Doppler-row TDM
    MIMO time-offset compensation applied (the per-detection
    ``mimo_compensate`` phase vectorized over all rows; exact host
    constants — cfg-static)."""
    import numpy as np

    from mmradar.ops.fuseddft import fused_rd_planes

    dr, di = fused_rd_planes(shorts, base_cube, cfg, window)
    d = cfg.doppler_fft_size
    fd = (np.arange(d) - d // 2) / (d * cfg.slow_time_interval_s)
    tx_idx = np.arange(cfg.num_virtual_rx) // cfg.num_rx
    ph = -2.0 * np.pi * fd[None, :] * tx_idx[:, None] * cfg.chirp_interval_s
    # per-channel calibration correction folds into the same host
    # constant (both are diagonal in V — one combined complex multiply)
    comb = np.exp(1j * ph)
    cal = cfg.rx_cal_vector()
    if cal is not None:
        comb = comb * cal[:, None]
    pr = jnp.asarray(comb.real, jnp.float32)[..., None]   # (V', D, 1)
    pi_ = jnp.asarray(comb.imag, jnp.float32)[..., None]
    return dr * pr - di * pi_, dr * pi_ + di * pr


@functools.partial(jax.jit, static_argnames=("cfg", "window"))
def range_azimuth_capon_from_shorts(
    shorts: jnp.ndarray,
    base_cube: jnp.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> jnp.ndarray:
    """High-resolution (Capon/MVDR) range-azimuth map.

    Per range bin, the D TDM-compensated Doppler rows are the snapshot
    set for the MVDR spectrum over the virtual array — sharper beams
    and better sidelobe rejection than the FFT map at the cost of a
    per-bin covariance inverse (V' x V' — tiny, batched over B*R bins).
    float64 twin: ``golden.range_azimuth_capon_map``.

    Returns:
      float32 (..., n_angles, range_fft) on the UNIFORM degree grid of
      ``cfg.angle_grid_deg`` (unlike the FFT map's sin-space bins —
      CLI/viz take the grid from ``aoa.angle_bins_deg``/the spectrum's
      own axis).
    """
    cr, ci = _tdm_compensated_rd(shorts, base_cube, cfg, window)
    x = jax.lax.complex(cr, ci)              # (..., V', D, R)
    x = jnp.swapaxes(jnp.moveaxis(x, -1, -3), -1, -2)   # (..., R, D, V')
    _, p = capon_spectrum(x, cfg)            # (..., R, n_angles)
    return jnp.swapaxes(p, -1, -2)
