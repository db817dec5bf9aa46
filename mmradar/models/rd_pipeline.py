"""Full range-Doppler-CFAR-AoA pipeline (the north-star extension).

One jitted program per frame batch:

    decode -> clutter removal -> windowed 2D FFT per RX (range-Doppler cube)
    -> non-coherent RX integration -> 2D CA-CFAR -> top-K detections
    -> per-detection angle-FFT AoA -> physical (range, velocity, azimuth)

Static shapes throughout: CFAR hits are folded into a fixed top-K list
(masked by validity) so the whole thing stays one compiled XLA program —
no data-dependent shapes.

The reference stops at a single argmax (acceleration.cu:522); stage
contracts here are defined by the golden model (mmradar/golden.py).

The stage helpers (`topk_cells`, `cell_physics`, `gather_snapshots`,
`aoa_from_snapshots`) are shared with the multi-chip version in
``mmradar.parallel.distributed``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG, LIGHT_SPEED
from mmradar.models.impls import resolve_impl
from mmradar.ops.aoa import angle_fft_spectrum
from mmradar.ops.decode import decode_to_cube
from mmradar.ops.preproc import mean_clutter_removal, mti_clutter_removal
from mmradar.ops.rangefft import range_doppler


def _declutter(x, base, cfg: RadarConfig):
    """``cfg.effective_clutter`` dispatch on a decoded cube-like array
    with the chirp axis at -2 (real plane or complex cube); ``base`` is
    the matching base array or None."""
    mode = cfg.effective_clutter(base is not None)
    if mode == "base":
        return x - base
    if mode == "mean":
        return mean_clutter_removal(x)
    return mti_clutter_removal(x, int(mode[-1]), axis=-2, stride=cfg.num_tx)


class RDResult(NamedTuple):
    """Batched detection results (leading axis = frames)."""

    num_hits: jnp.ndarray        # int32 (B,) CFAR hit count
    doppler_bin: jnp.ndarray     # int32 (B, K) top-K cell indices
    range_bin: jnp.ndarray       # int32 (B, K)
    power: jnp.ndarray           # float32 (B, K) integrated cell power
    valid: jnp.ndarray           # bool (B, K) detection passed CFAR
    range_m: jnp.ndarray         # float32 (B, K) bin-quantized (~39 cm grid)
    velocity_mps: jnp.ndarray    # float32 (B, K)
    azimuth_deg: jnp.ndarray     # float32 (B, K) angle-FFT + sub-bin interp
    angle_bin: jnp.ndarray       # int32 (B, K) argmax angle-FFT bin
    range_m_interp: jnp.ndarray  # float32 (B, K) sub-bin parabolic range
    velocity_mps_interp: jnp.ndarray  # float32 (B, K) sub-bin velocity


# --------------------------------------------------------------------------
# shared stage helpers
# --------------------------------------------------------------------------

def topk_cells(power: jnp.ndarray, hits: jnp.ndarray, k: int):
    """Fold a CFAR hit map into a static top-K detection list
    (``lax.top_k``: descending power, ties and exhausted slots in
    ascending cell order).

    Args:
      power: float32 (..., D, R); hits: bool (..., D, R).

    Returns:
      (num_hits (...,), top_idx (..., K) flat cell index, top_power,
      valid, d_bin, r_bin).
    """
    d_size, r_size = power.shape[-2], power.shape[-1]
    num_hits = jnp.sum(hits, axis=(-2, -1)).astype(jnp.int32)
    masked = jnp.where(hits, power, -jnp.inf)
    flat = masked.reshape(masked.shape[:-2] + (d_size * r_size,))
    top_power, top_idx = jax.lax.top_k(flat, k)
    valid = jnp.isfinite(top_power)
    top_power = jnp.where(valid, top_power, 0.0)
    d_bin = (top_idx // r_size).astype(jnp.int32)
    r_bin = (top_idx % r_size).astype(jnp.int32)
    return num_hits, top_idx, top_power, valid, d_bin, r_bin


def cell_physics(d_bin: jnp.ndarray, r_bin: jnp.ndarray, cfg: RadarConfig):
    """Map (doppler, range) bins to (velocity m/s, range m)."""
    rng_hz = r_bin.astype(jnp.float32) * (cfg.sample_rate_hz / cfg.range_fft_size)
    range_m = rng_hz * jnp.float32(LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s))
    dopp_hz = (d_bin - cfg.doppler_fft_size // 2).astype(jnp.float32) / jnp.float32(
        cfg.doppler_fft_size * cfg.slow_time_interval_s
    )
    velocity = dopp_hz * jnp.float32(cfg.wavelength_m / 2.0)
    return range_m, velocity


def virtualize_cube(cube: jnp.ndarray, cfg: RadarConfig) -> jnp.ndarray:
    """TDM-MIMO de-multiplex (twin of golden.virtual_cube):
    (..., rx, chirps, samples) -> (..., tx*rx, chirps_per_tx, samples)."""
    if cfg.num_tx == 1:
        return cube
    parts = [cube[..., :, tx::cfg.num_tx, :] for tx in range(cfg.num_tx)]
    return jnp.concatenate(parts, axis=-3)


def apply_rx_cal(
    x: jnp.ndarray, cfg: RadarConfig, axis: int = -1
) -> jnp.ndarray:
    """Multiply the per-virtual-channel calibration correction
    (``cfg.rx_cal``, twin of golden.apply_rx_cal) along ``axis``.
    Identity (no-op) when no calibration is configured; the correction
    is a compile-time complex64 constant otherwise, so the cost is one
    tiny fused elementwise multiply on the KB-sized snapshot tensors.
    """
    cal = cfg.rx_cal_vector()
    if cal is None:
        return x
    shape = [1] * x.ndim
    shape[axis] = -1
    return x * jnp.asarray(cal, jnp.complex64).reshape(shape)


def mimo_compensate(
    snaps: jnp.ndarray, d_bin: jnp.ndarray, cfg: RadarConfig
) -> jnp.ndarray:
    """Remove the TDM time-offset Doppler phase from virtual snapshots
    (twin of golden.mimo_doppler_compensate).

    Args:
      snaps: complex64 (..., K, V); d_bin: int32 (..., K).
    """
    if cfg.num_tx == 1:
        return snaps
    d = cfg.doppler_fft_size
    fd = (d_bin - d // 2).astype(jnp.float32) / jnp.float32(
        d * cfg.slow_time_interval_s
    )
    tx_idx = (jnp.arange(cfg.num_virtual_rx) // cfg.num_rx).astype(jnp.float32)
    phase = (-2.0 * jnp.pi * cfg.chirp_interval_s) * fd[..., None] * tx_idx
    return snaps * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def gather_snapshots(rd: jnp.ndarray, top_idx: jnp.ndarray) -> jnp.ndarray:
    """Gather per-detection RX snapshots from the RD cube.

    Gathers in the cube's native (..., rx, D, R) layout and transposes only
    the tiny (rx, K) result — a moveaxis-first formulation materializes a
    full transposed copy of the RD cube (~270 MB/512-frame batch) just to
    pick K cells out of it.

    Args:
      rd: complex64 or float32 (..., rx, D, R); top_idx: int32 (..., K)
        flat D*R cell index.

    Returns:
      (..., K, rx), dtype of ``rd``.
    """
    d_size, r_size = rd.shape[-2], rd.shape[-1]
    flat = rd.reshape(rd.shape[:-2] + (d_size * r_size,))  # (..., rx, D*R)
    idx = top_idx[..., None, :]  # (..., 1, K) broadcast over rx
    picked = jnp.take_along_axis(flat, idx, axis=-1)  # (..., rx, K)
    return jnp.swapaxes(picked, -2, -1)


def aoa_from_snapshots(snaps: jnp.ndarray, cfg: RadarConfig):
    """Angle-FFT AoA per detection with sub-bin peak interpolation.

    snaps: complex64 (..., K, rx).  The angle axis is circular (the
    angle-FFT spans the full sin-space period), so the parabola's
    neighbors wrap.  The 3-point log fit interpolates in sin(theta) —
    where the FFT grid is uniform — before the arcsin.
    """
    spec = angle_fft_spectrum(snaps, cfg)
    aspec = spec.real * spec.real + spec.imag * spec.imag
    angle_bin = jnp.argmax(aspec, axis=-1).astype(jnp.int32)
    n = cfg.num_angle_bins
    # one batched gather for all three parabola samples (see the
    # matching note in interp_cell_physics)
    idx3 = jnp.stack(
        [(angle_bin - 1) % n, angle_bin, (angle_bin + 1) % n], axis=-1
    )
    g3 = jnp.take_along_axis(aspec, idx3, axis=-1)
    off = _parabolic_core(g3[..., 0], g3[..., 1], g3[..., 2])
    sin_theta = (angle_bin.astype(jnp.float32) + off - n // 2) / jnp.float32(
        n * cfg.rx_spacing_wavelengths
    )
    azimuth = jnp.rad2deg(jnp.arcsin(jnp.clip(sin_theta, -1.0, 1.0)))
    return azimuth, angle_bin


def _parabolic_core(pm, pc, pp):
    """Sub-bin offset in [-0.5, 0.5] from three power samples
    (twin of golden.parabolic_bin_offset)."""
    eps = 1e-30
    lm = jnp.log(jnp.maximum(pm, eps))
    lc = jnp.log(jnp.maximum(pc, eps))
    lp = jnp.log(jnp.maximum(pp, eps))
    denom = lm - 2.0 * lc + lp
    offset = jnp.where(
        jnp.abs(denom) > 1e-12,
        0.5 * (lm - lp) / jnp.where(denom == 0, 1.0, denom),
        0.0,
    )
    return jnp.clip(offset, -0.5, 0.5)


def interp_cell_physics(power, top_idx, d_bin, r_bin, cfg: RadarConfig):
    """Sub-bin (range, velocity) via 3-point log-parabolic interpolation.

    The reference quantizes range to the FFT grid (~39 cm at defaults,
    acceleration.cu:522); a windowed spectral peak's true position is
    recoverable to a few mm from the two neighbor cells.  Range neighbors
    clamp at the map edges (degrading gracefully to offset 0); Doppler
    neighbors wrap (circular axis).

    Args:
      power: (..., D, R); top_idx/d_bin/r_bin: (..., K).

    Returns:
      (range_m_interp, velocity_mps_interp), float32 (..., K).
    """
    d_size, r_size = power.shape[-2], power.shape[-1]
    flat = power.reshape(power.shape[:-2] + (-1,))

    # ONE batched gather for all five neighbor samples (one op instead
    # of five separate take_along_axis fusions)
    k = top_idx.shape[-1]
    idx5 = jnp.concatenate(
        [
            top_idx,
            top_idx - jnp.where(r_bin > 0, 1, 0),
            top_idx + jnp.where(r_bin < r_size - 1, 1, 0),
            ((d_bin - 1) % d_size) * r_size + r_bin,
            ((d_bin + 1) % d_size) * r_size + r_bin,
        ],
        axis=-1,
    )
    g5 = jnp.take_along_axis(flat, idx5, axis=-1)
    pc = g5[..., 0 * k : 1 * k]
    prm = g5[..., 1 * k : 2 * k]
    prp = g5[..., 2 * k : 3 * k]
    pdm = g5[..., 3 * k : 4 * k]
    pdp = g5[..., 4 * k : 5 * k]

    r_off = _parabolic_core(prm, pc, prp)
    # a clamped neighbor equals the center sample, collapsing the parabola
    # to a spurious ±0.5; edge cells have no sub-bin information -> 0
    at_edge = (r_bin == 0) | (r_bin == r_size - 1)
    r_off = jnp.where(at_edge, 0.0, r_off)
    bin_r = r_bin.astype(jnp.float32) + r_off
    scale = cfg.sample_rate_hz / cfg.range_fft_size
    range_m = bin_r * jnp.float32(
        scale * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)
    )

    d_off = _parabolic_core(pdm, pc, pdp)
    bin_d = (d_bin - d_size // 2).astype(jnp.float32) + d_off
    dopp_hz = bin_d / jnp.float32(d_size * cfg.slow_time_interval_s)
    velocity = dopp_hz * jnp.float32(cfg.wavelength_m / 2.0)
    return range_m, velocity


def assemble_result(power, rd_snaps, hits, k: int,
                    cfg: RadarConfig) -> RDResult:
    """Tail shared by local and distributed pipelines: top-K + physics + AoA.

    Args:
      power: (..., D, R) integrated power (full map).
      rd_snaps: callable top_idx -> (..., K, rx) snapshot gatherer.
    """
    guard = cfg.range_edge_guard_effective
    if guard:
        # top-edge range bins excluded from detection: circularly
        # wrapped window sidelobes of strong near-range targets make
        # those cells persistent false alarms under 'reflect' CFAR (see
        # RadarConfig.range_edge_guard)
        r_idx = jnp.arange(power.shape[-1])
        hits = hits & (r_idx < power.shape[-1] - guard)
    num_hits, top_idx, top_power, valid, d_bin, r_bin = topk_cells(
        power, hits, k
    )
    range_m, velocity = cell_physics(d_bin, r_bin, cfg)
    range_interp, vel_interp = interp_cell_physics(
        power, top_idx, d_bin, r_bin, cfg
    )
    snaps = mimo_compensate(apply_rx_cal(rd_snaps(top_idx), cfg), d_bin, cfg)
    azimuth, angle_bin = aoa_from_snapshots(snaps, cfg)
    return RDResult(
        num_hits=num_hits,
        doppler_bin=d_bin,
        range_bin=r_bin,
        power=top_power,
        valid=valid,
        range_m=range_m,
        velocity_mps=velocity,
        azimuth_deg=azimuth,
        angle_bin=angle_bin,
        range_m_interp=range_interp,
        velocity_mps_interp=vel_interp,
    )


@jax.jit
def pack_detections(out: RDResult) -> jnp.ndarray:
    """Pack the serving-relevant RDResult fields into ONE (B, K, 9) f32
    array: [range_m, velocity_mps, azimuth_deg, power, valid,
    range_m_interp, velocity_mps_interp, doppler_bin, range_bin].

    Serving materializes results every dispatch; one packed array is one
    device-to-host transfer instead of ten.  The trailing bin columns feed
    the optional Capon/2D AoA refinement dispatch (``cli serve
    --refine``) without a second result transfer.
    """
    return jnp.stack(
        [
            out.range_m,
            out.velocity_mps,
            out.azimuth_deg,
            out.power,
            out.valid.astype(jnp.float32),
            out.range_m_interp,
            out.velocity_mps_interp,
            out.doppler_bin.astype(jnp.float32),
            out.range_bin.astype(jnp.float32),
        ],
        axis=-1,
    )


def integrate_power(rd: jnp.ndarray) -> jnp.ndarray:
    """Non-coherent integration over the RX axis: (..., rx, D, R) -> (..., D, R)."""
    return jnp.sum(rd.real * rd.real + rd.imag * rd.imag, axis=-3)


# --------------------------------------------------------------------------
# single-device (or auto-sharded) pipeline
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RDPipeline:
    """Frame-batched range-Doppler-CFAR-AoA detector.

    Frozen + hashed by value: ``self`` is a jit static argument, so two
    identically-configured pipelines share one compiled program, and
    mutating an impl after the first call raises instead of silently
    reusing a stale compilation.

    Attributes:
      cfar_impl: 'auto' or 'xla' (``ops.cfar.cfar_detect``).
      rd_impl: 'auto' (= 'fft'), 'fft' (complex cube, FFT library
        transforms), 'mxu' (complex cube, DFT as matmuls), 'planar'
        (split re/im f32 planes from decode through power — the complex
        RD cube never materializes), or 'fused' (de-interleave +
        transpose + window folded into the DFT matmuls themselves; see
        ops/fuseddft.py).
      topk_impl: 'auto' or 'xla' (``lax.top_k``).

    Every selector resolves through ``models.impls.resolve_impl``; an
    unknown value raises ``ValueError`` at construction.
    """

    cfg: RadarConfig = DEFAULT_CONFIG
    max_detections: int = 16
    use_base_frame: bool = True
    cfar_impl: str = "auto"
    rd_impl: str = "auto"
    topk_impl: str = "auto"
    # keystone range-migration compensation (ops/keystone.py): rescale
    # slow time per fast-time sample before the FFTs so intra-CPI range
    # walk vanishes for unambiguous velocities.  Needs the complex-cube
    # front-end (the transform's input is the virtualized cube), so it
    # forces rd_impl 'fft'/'mxu'; an explicit incompatible pin raises.
    keystone: bool = False

    def __post_init__(self):
        for field in ("rd_impl", "cfar_impl", "topk_impl"):
            resolve_impl(field, getattr(self, field))

    def _cfar(self, power, hits_only=False, cfg=None):
        from mmradar.ops.cfar import cfar_detect

        cfg = self.cfg if cfg is None else cfg
        return cfar_detect(power, cfg, hits_only=hits_only)

    # -- base frame --------------------------------------------------------
    @partial(jax.jit, static_argnums=0)
    def prepare_base(self, frame0_shorts: jnp.ndarray) -> jnp.ndarray:
        """Full-cube base frame (rx, chirps, samples) kept in HBM.

        Accepts ONE frame ``(shorts_per_frame,)`` or a STACK
        ``(K, shorts_per_frame)`` of empty-scene frames, averaged into
        one base cube.  Averaging matters because base subtraction
        re-uses the base's noise realization in EVERY processed frame:
        with a single noisy base, false alarms cluster at fixed cells
        and persist frame-to-frame (the quenched-noise finding,
        MIGRATION round-5 notes); K base frames cut that quenched floor
        by 1/K while the deterministic clutter estimate is unchanged.
        ``cli detect/track/serve --base-frames K`` feed the stack.
        """
        cube = decode_to_cube(frame0_shorts, self.cfg)
        if cube.ndim == 4:
            cube = jnp.mean(cube, axis=0)
        return cube

    # -- stages (exposed for stage-level golden verification) --------------
    def rd_cube(self, shorts: jnp.ndarray, base_cube: jnp.ndarray | None):
        """(B, rx, doppler, range) complex range-Doppler maps."""
        cube = decode_to_cube(shorts, self.cfg)
        base = base_cube if self.use_base_frame else None
        cube = _declutter(cube, base, self.cfg)
        cube = virtualize_cube(cube, self.cfg)
        if self.keystone:
            from mmradar.ops.keystone import keystone_cube

            cube = keystone_cube(cube, self.cfg)
        if self._resolve_rd_impl() == "mxu":
            from mmradar.ops.dftmat import range_doppler_mxu

            return range_doppler_mxu(cube, self.cfg)
        return range_doppler(cube, self.cfg)

    # -- Capon high-resolution AoA refinement -------------------------------
    @partial(jax.jit, static_argnums=0)
    def capon_refine(
        self,
        shorts: jnp.ndarray,
        base_cube: jnp.ndarray | None,
        d_bin: jnp.ndarray,
        r_bin: jnp.ndarray,
    ) -> jnp.ndarray:
        """MVDR azimuth (B, K) for already-detected cells.

        Uses chirp-domain snapshots at each detection's range bin (the
        Doppler axis provides the covariance averaging), with TDM phase
        compensation.  Sharper than the angle-FFT estimate in RDResult;
        run it on demand for confirmed detections.
        """
        from mmradar.ops.aoa import capon_aoa_at_cells
        from mmradar.ops.rangefft import range_fft  # noqa: F401 (doc ref)
        from mmradar.ops.window import make_window

        cfg = self.cfg
        cube = decode_to_cube(shorts, cfg)
        base = base_cube if self.use_base_frame else None
        cube = _declutter(cube, base, cfg)
        cube = apply_rx_cal(virtualize_cube(cube, cfg), cfg, axis=-3)  # (B, V, CPT, S)
        x = cube * make_window(cube.shape[-1], cfg.window_kind, jnp.float32)
        rng = jnp.fft.fft(x, n=cfg.range_fft_size, axis=-1)
        return capon_aoa_at_cells(rng, d_bin, r_bin, cfg)

    # -- TDM velocity disambiguation ----------------------------------------
    @partial(jax.jit, static_argnums=0)
    def disambiguate(
        self,
        shorts: jnp.ndarray,
        base_cube: jnp.ndarray | None,
        d_bin: jnp.ndarray,
        r_bin: jnp.ndarray,
    ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(velocity_mps, azimuth_deg, hypothesis) (B, K) for detected
        cells, over the EXTENDED velocity span.

        TDM-MIMO divides the unambiguous velocity by ``num_tx``; the
        hypothesis test (``ops.aoa.disambiguate_velocity``) recovers the
        full single-TX span by picking the TDM compensation that keeps
        the virtual array coherent, and the azimuth is re-estimated from
        the winning compensation (the default estimate is biased for
        wrapped targets because it compensated with the aliased
        Doppler).  Run on demand for confirmed detections, like
        :meth:`capon_refine`.
        """
        from mmradar.ops.aoa import disambiguate_velocity
        from mmradar.ops.fuseddft import fused_rd_planes

        cfg = self.cfg
        base = base_cube if self.use_base_frame else None
        dr_p, di_p = fused_rd_planes(shorts, base, cfg)
        top_idx = d_bin * cfg.range_fft_size + r_bin
        snaps = apply_rx_cal(jax.lax.complex(
            gather_snapshots(dr_p, top_idx), gather_snapshots(di_p, top_idx)
        ), cfg)
        vel, hyp, comp = disambiguate_velocity(snaps, d_bin, cfg)
        azimuth, _ = aoa_from_snapshots(comp, cfg)
        return vel, azimuth, hyp

    # -- joint azimuth/elevation refinement (planar virtual arrays) ----------
    @partial(jax.jit, static_argnums=0)
    def refine_2d(
        self,
        shorts: jnp.ndarray,
        base_cube: jnp.ndarray | None,
        d_bin: jnp.ndarray,
        r_bin: jnp.ndarray,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(azimuth_deg, elevation_deg) (B, K) for detected cells.

        Requires an elevated TX (``cfg.tx_positions_wl``) for a planar
        virtual array; with a 1D ULA the elevation estimate is degenerate
        (the grid scan returns the boresight row).  Run on demand for
        confirmed detections, like :meth:`capon_refine`.
        """
        from mmradar.ops.aoa import aoa_2d_from_snapshots
        from mmradar.ops.fuseddft import fused_rd_planes

        cfg = self.cfg
        base = base_cube if self.use_base_frame else None
        dr_p, di_p = fused_rd_planes(shorts, base, cfg)
        top_idx = d_bin * cfg.range_fft_size + r_bin
        snaps = apply_rx_cal(jax.lax.complex(
            gather_snapshots(dr_p, top_idx), gather_snapshots(di_p, top_idx)
        ), cfg)
        snaps = mimo_compensate(snaps, d_bin, cfg)
        return aoa_2d_from_snapshots(snaps, cfg)

    def _resolve_rd_impl(self) -> str:
        impl = resolve_impl("rd_impl", self.rd_impl)
        if self.keystone and impl not in ("fft", "mxu"):
            raise ValueError(
                f"keystone=True needs the complex-cube front-end "
                f"(rd_impl 'auto'/'fft'/'mxu'), got {self.rd_impl!r}: the "
                "keystone resamples the virtualized complex cube, which "
                "the planar and fused front-ends never form"
            )
        return impl

    @partial(jax.jit, static_argnums=0)
    def maps(
        self, shorts: jnp.ndarray, base_cube: jnp.ndarray | None = None
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(power (..., D, R) f32, CFAR hits bool) of the resolved
        front-end: the maps :meth:`detect` folds into detections, for
        stage-level verification and timing."""
        power, hits, _ = self._maps(shorts, base_cube,
                                    self._resolve_rd_impl())
        return power, hits

    # -- full pipeline ------------------------------------------------------
    @partial(jax.jit, static_argnums=0)
    def detect(
        self, shorts: jnp.ndarray, base_cube: jnp.ndarray | None = None
    ) -> RDResult:
        impl = self._resolve_rd_impl()
        power, hits, snaps_fn = self._maps(shorts, base_cube, impl)
        return assemble_result(
            power, snaps_fn, hits, self.max_detections, self.cfg
        )

    @partial(jax.jit, static_argnums=0)
    def detect_objects(
        self, shorts: jnp.ndarray, base_cube: jnp.ndarray | None = None
    ):
        """:meth:`detect` plus object-level clustering of the CFAR hit
        map (``ops.cluster``): returns ``(RDResult, ClusterResult)``.

        Clustering consumes the same power/hit maps the detector
        thresholds; CFAR kind, top-K and AoA are the normal dispatch.
        """
        from mmradar.ops.cluster import cluster_detections

        cfg = self.cfg
        impl = self._resolve_rd_impl()
        power, hits, snaps_fn = self._maps(shorts, base_cube, impl)
        out = assemble_result(
            power, snaps_fn, hits, self.max_detections, cfg
        )
        clusters = cluster_detections(
            power, hits, out.doppler_bin, out.range_bin, out.valid, cfg
        )
        return out, clusters

    @partial(jax.jit, static_argnums=(0, 3, 4))
    def detect_integrated(
        self,
        shorts: jnp.ndarray,
        base_cube: jnp.ndarray | None = None,
        n_integrate: int = 2,
        range_walk: bool = False,
    ) -> RDResult:
        """Non-coherent integration: sum ``n_integrate`` consecutive
        frames' RD power maps, then CFAR + detection on the summed map.

        The classic low-SNR Pd lever: a target steady within its RD cell
        over N frames integrates linearly in power while the noise
        fluctuation around its (also-scaled) mean shrinks like 1/sqrt(N),
        so weak targets climb out of the CFAR threshold band.  For
        ``cfar_kind='ca'`` the threshold is INTEGRATION-MATCHED — the
        alpha is re-solved for Erlang-N cells
        (``ops.cfar.cfar_alpha(n_pulses=N)``); without that the gain is
        mostly thrown away (the single-pulse alpha holds a deterministic
        gap above the N-scaled noise mean that variance averaging cannot
        cross — measured Pd 0.28 -> 0.38 at the knee vs -> 1.0 matched).
        'goca'/'soca' are matched too (the Gandhi-Kassam double-sum
        generalization); 'os' keeps its single-pulse alpha — realized
        Pfa below configured, partial Pd gain;
        ``cli eval --integrate`` measures both.

        Pair integration with a FRESH-NOISE clutter mode ('mean', 'mti2'/
        'mti3', or no clutter removal) — measured finding: under
        base-frame subtraction every frame carries the SAME base-noise
        realization, which integrates coherently (N^2 * |N0|^2 vs
        N * sigma^2 for the fresh noise), so the summed map is dominated
        by one un-averaged noise realization and Pd can come out BELOW
        single-frame (observed 0.25 -> 0.0 at the Pd knee on the default
        geometry).  The fix is structural, not a bug: re-using one
        empty-scene frame (the reference's own design,
        cudaBenchMarking.cpp:242-250) is exactly what NCI's variance
        averaging cannot forgive.

        ``range_walk=True`` adds Doppler-conditioned range alignment
        before the sum: each Doppler bin's rows are shifted by its OWN
        velocity's per-frame range migration
        (``round(v_d * (N-1-f) * dt / r_res)`` bins, aligning every
        frame onto the LAST frame's range grid), so fast targets keep
        integrating past the one-cell-per-group limit the plain sum
        imposes (a map-level form of range-migration-compensated NCI;
        the full keystone transform interpolates slow time instead).
        The shift uses the map's ALIASED velocity — targets beyond the
        unambiguous span walk by their true velocity and stay smeared.
        Cells shifted in from outside the window are ZERO, which thins
        the CFAR training ring within ~v_max*N*dt/r_res bins of the
        range edges (~2–3 bins at N=8 on the default geometry).

        AoA snapshots are gathered from each group's LAST frame (targets
        must hold their cell across the group — the same assumption the
        plain integration makes; under ``range_walk`` the aligned grid
        IS the last frame's).  Returns one :class:`RDResult` row
        per group (``B // n_integrate`` results); ``B`` must divide.

        Reference contrast: the reference detects on single 16K spectra
        (acceleration.cu:522) and has no multi-frame integration.
        """
        cfg = self.cfg
        n = int(n_integrate)
        if n < 1:
            raise ValueError(f"n_integrate must be >= 1, got {n}")
        b = shorts.shape[0]
        if b % n:
            raise ValueError(
                f"batch of {b} frames does not divide into groups of "
                f"{n}; pass a multiple (cli detect --integrate trims)"
            )
        impl = self._resolve_rd_impl()
        power, _, _ = self._maps(shorts, base_cube, impl, want_hits=False)
        pw = power.reshape((b // n, n) + power.shape[1:])
        if range_walk and n > 1:
            import numpy as onp

            from mmradar.config import LIGHT_SPEED

            d_sz, r_sz = cfg.doppler_fft_size, cfg.range_fft_size
            dt_f = cfg.num_chirps * cfg.chirp_interval_s
            r_res = ((cfg.sample_rate_hz / r_sz) * LIGHT_SPEED
                     / (2.0 * cfg.slope_hz_per_s))
            v_d = ((onp.arange(d_sz) - d_sz // 2)
                   / (d_sz * cfg.slow_time_interval_s)
                   * cfg.wavelength_m / 2.0)
            shift = onp.rint(
                v_d[None, :] * (n - 1 - onp.arange(n))[:, None]
                * dt_f / r_res
            ).astype(onp.int32)                             # (N, D)
            src = onp.arange(r_sz)[None, None, :] - shift[:, :, None]
            ok_src = jnp.asarray((src >= 0) & (src < r_sz))
            src_c = jnp.asarray(onp.clip(src, 0, r_sz - 1))
            pw = jnp.where(
                ok_src,
                jnp.take_along_axis(
                    pw, jnp.broadcast_to(src_c, pw.shape), axis=-1
                ),
                0.0,
            )
        p_int = pw.sum(axis=1)
        # integration-matched threshold: Erlang-N cells need their own
        # alpha (ops.cfar.cfar_alpha n_pulses) or the gain is thrown away
        import dataclasses

        # compose with the per-frame pulse count (default: the
        # Erlang-matched num_virtual_rx RX-power sum) so the threshold
        # models the FULL integration order n * per-frame
        cfg_int = dataclasses.replace(
            cfg, cfar_n_pulses=n * cfg.cfar_pulses_effective
        )
        hits = self._cfar(p_int, hits_only=True, cfg=cfg_int)[0]
        # snapshots from each group's last frame: the front-end re-runs
        # on the 1/n subset
        last = shorts.reshape((b // n, n) + shorts.shape[1:])[:, -1]
        _, _, snaps_fn = self._maps(last, base_cube, impl, want_hits=False)
        return assemble_result(
            p_int, snaps_fn, hits, self.max_detections, cfg
        )

    @partial(jax.jit, static_argnums=(0,),
             static_argnames=("beta", "block"))
    def detect_cmap(
        self,
        shorts: jnp.ndarray,
        base_cube: jnp.ndarray | None = None,
        beta: float = 0.25,
        m0: jnp.ndarray | None = None,
        block: int = 16,
    ) -> tuple[RDResult, jnp.ndarray]:
        """Detection with the CLUTTER-MAP detector instead of spatial
        CFAR: each cell's threshold comes from its own recursive
        background over frames (``ops.cmap.clutter_map_cfar``) — exact
        wherever the clutter floor varies across the map, which is
        where a spatial training ring averages two levels and gets both
        sides wrong.  Stateful: pass the previous call's returned map as
        ``m0`` to continue a stream (the serve path does); without it
        the first frame seeds the map and emits no hits (warmup).

        Returns ``(RDResult, m_out)``.
        """
        from mmradar.ops.cmap import clutter_map_cfar

        cfg = self.cfg
        impl = self._resolve_rd_impl()
        power, _, snaps_fn = self._maps(shorts, base_cube, impl,
                                        want_hits=False)
        hits, m_out = clutter_map_cfar(
            power, cfg.cfar_pfa, beta, m0, seeded=m0 is not None,
            block=block, n_pulses=cfg.cfar_pulses_effective,
        )
        out = assemble_result(
            power, snaps_fn, hits, self.max_detections, cfg
        )
        return out, m_out

    # -- streaming ingest: donated input buffer ------------------------------
    @partial(jax.jit, static_argnums=0, donate_argnums=1)
    def detect_donated(
        self, shorts: jnp.ndarray, base_cube: jnp.ndarray | None = None
    ) -> RDResult:
        """:meth:`detect` with the raw frame buffer DONATED.

        For sustained host->HBM streaming: each uploaded cube's HBM buffer
        is released to XLA the moment the step consumes it, so back-to-back
        upload/compute overlap does not accumulate dead input buffers (the
        answer to the reference's 6 cudaMalloc/cudaFree pairs per frame,
        acceleration.cu:435-519).  The caller must not reuse
        ``shorts`` after the call.
        """
        return self.detect(shorts, base_cube)

    def _maps(self, shorts, base_cube, impl, want_hits=True):
        """Run the selected RD front-end up to its (power, hits) maps.

        Returns ``(power, hits, snaps_fn)`` where ``snaps_fn(top_idx)``
        gathers the per-detection complex virtual-RX snapshots.
        'planar' and 'fused' stay in split f32 re/im planes from decode
        through power; complex only reappears on the tiny (B, K, rx)
        snapshots.  ``want_hits=False``
        skips per-frame CFAR and returns ``hits=None`` — the
        non-coherent-integration path runs CFAR on the SUMMED maps
        instead (:meth:`detect_integrated`)."""
        cfg = self.cfg
        base = base_cube if self.use_base_frame else None
        if impl in ("fused", "planar"):
            if impl == "fused":
                from mmradar.ops.fuseddft import fused_rd_planes

                dr, di = fused_rd_planes(shorts, base, cfg)
            else:
                from mmradar.ops.decode import decode_to_planes
                from mmradar.ops.dftmat import range_doppler_planes

                re, im = decode_to_planes(shorts, cfg)
                # clutter removal is linear: per-plane == complex form
                re = _declutter(re, None if base is None else base.real, cfg)
                im = _declutter(im, None if base is None else base.imag, cfg)
                re = virtualize_cube(re, cfg)
                im = virtualize_cube(im, cfg)
                dr, di = range_doppler_planes(re, im, cfg)  # (B, rx, D, R)
            power = jnp.sum(dr * dr + di * di, axis=-3)
            hits = self._cfar(power, hits_only=True)[0] if want_hits else None
            return power, hits, lambda top_idx: jax.lax.complex(
                gather_snapshots(dr, top_idx), gather_snapshots(di, top_idx)
            )
        # complex-cube path ('fft' — the auto default — and 'mxu')
        rd = self.rd_cube(shorts, base_cube)  # (B, rx, D, R)
        power = integrate_power(rd)
        hits = self._cfar(power, hits_only=True)[0] if want_hits else None
        return power, hits, lambda top_idx: gather_snapshots(rd, top_idx)
