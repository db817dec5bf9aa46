"""TDM-MIMO virtual array (2 TX x 4 RX = 8 virtual elements)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.capture import decode_shorts, encode_frame
from mmradar.io.synthetic import SceneTarget, synthesize_capture, synthesize_cube
from mmradar.models.rd_pipeline import RDPipeline
from mmradar.parallel.distributed import DistributedRDPipeline
from mmradar.parallel.mesh import build_mesh


@pytest.fixture(scope="module")
def mcfg() -> RadarConfig:
    return RadarConfig(num_tx=2)


def test_config_derived_sizes(mcfg):
    assert mcfg.num_virtual_rx == 8
    assert mcfg.chirps_per_tx == 64
    assert mcfg.doppler_fft_size == 64
    assert mcfg.slow_time_interval_s == pytest.approx(128e-6)
    # frame layout on disk is unchanged (TDM shares the RX chain)
    assert mcfg.shorts_per_frame == RadarConfig().shorts_per_frame


def test_virtual_cube_demux(mcfg):
    rng = np.random.default_rng(5)
    cube = rng.standard_normal((4, 128, 100)) + 0j
    v = golden.virtual_cube(cube, mcfg)
    assert v.shape == (8, 64, 100)
    # v = tx*num_rx + rx takes chirps tx::2 of physical rx
    np.testing.assert_array_equal(v[2], cube[2, 0::2])
    np.testing.assert_array_equal(v[6], cube[2, 1::2])


def test_mimo_azimuth_recovery(mcfg):
    """8-element virtual array recovers azimuth with moving targets
    (exercises the TDM Doppler compensation)."""
    targets = [
        SceneTarget(range_m=5.0, velocity_mps=3.0, azimuth_deg=30.0,
                    amplitude=2500.0),
        SceneTarget(range_m=9.0, velocity_mps=-2.0, azimuth_deg=-40.0,
                    amplitude=2000.0),
    ]
    shorts = synthesize_capture(targets, 3, mcfg, noise_std=2.0, seed=21)
    pipe = RDPipeline(mcfg, max_detections=8)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    for f in range(2):
        vals = [
            (float(out.range_m[f, k]), float(out.velocity_mps[f, k]),
             float(out.azimuth_deg[f, k]))
            for k in range(8) if bool(out.valid[f, k])
        ]
        for tgt in targets:
            best = min(vals, key=lambda v: abs(v[0] - tgt.range_m))
            assert abs(best[0] - tgt.range_m) < 1.0
            assert abs(best[1] - tgt.velocity_mps) < 1.0
            # 8-element array: finer angle resolution than 4-element
            assert abs(best[2] - tgt.azimuth_deg) < 7.0, (tgt, best)


def test_compensation_matters(mcfg):
    """Without TDM Doppler compensation a fast target's azimuth is biased."""
    tgt = SceneTarget(range_m=5.0, velocity_mps=6.0, azimuth_deg=0.0,
                      amplitude=2500.0)
    cube = synthesize_cube([tgt], 2, mcfg, noise_std=0.5, seed=23)
    x = golden.virtual_cube(cube[1] - cube[0], mcfg)
    rd = golden.range_doppler_map(x, mcfg)
    power = np.abs(rd).sum(axis=0)
    d, r = np.unravel_index(np.argmax(power), power.shape)
    snap = rd[:, d, r]
    spec_raw = golden.angle_fft(snap, mcfg.num_angle_bins, mcfg)
    raw_deg = golden.angle_bin_to_deg(
        int(np.argmax(np.abs(spec_raw))), mcfg.num_angle_bins, mcfg
    )
    comp = golden.mimo_doppler_compensate(snap, d, mcfg)
    spec_c = golden.angle_fft(comp, mcfg.num_angle_bins, mcfg)
    comp_deg = golden.angle_bin_to_deg(
        int(np.argmax(np.abs(spec_c))), mcfg.num_angle_bins, mcfg
    )
    assert abs(comp_deg - 0.0) < 4.0
    assert abs(comp_deg - 0.0) < abs(raw_deg - 0.0)


def test_mimo_rd_cube_matches_golden(mcfg):
    tgt = SceneTarget(range_m=6.0, velocity_mps=2.0, azimuth_deg=10.0)
    cube = synthesize_cube([tgt], 2, mcfg, noise_std=1.0, seed=29)
    x64 = decode_shorts(encode_frame(cube[1], mcfg), mcfg) - cube[0]
    want = golden.range_doppler_map(golden.virtual_cube(x64, mcfg), mcfg)
    pipe = RDPipeline(mcfg)
    got = np.asarray(
        pipe.rd_cube(
            jnp.asarray(encode_frame(cube[1], mcfg)),
            jnp.asarray(cube[0].astype(np.complex64)),
        )
    )
    assert got.shape == want.shape == (8, 64, 128)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


def test_mimo_distributed_matches_single(mcfg):
    targets = [SceneTarget(range_m=5.0, velocity_mps=3.0, azimuth_deg=25.0)]
    shorts = synthesize_capture(targets, 9, mcfg, noise_std=2.0, seed=31)
    single = RDPipeline(mcfg, max_detections=8)
    base_s = single.prepare_base(jnp.asarray(shorts[0]))
    want = single.detect(jnp.asarray(shorts[1:]), base_s)

    mesh = build_mesh(n_devices=8, num_rx=mcfg.num_rx)
    dist = DistributedRDPipeline(mesh=mesh, cfg=mcfg, max_detections=8)
    got = dist.detect(dist.shard_frames(shorts[1:]), dist.prepare_base(shorts[0]))

    np.testing.assert_array_equal(
        np.asarray(got.range_bin), np.asarray(want.range_bin)
    )
    np.testing.assert_array_equal(
        np.asarray(got.angle_bin), np.asarray(want.angle_bin)
    )
    np.testing.assert_allclose(
        np.asarray(got.azimuth_deg), np.asarray(want.azimuth_deg), atol=1e-4
    )


def test_capon_refine_beats_angle_fft(mcfg):
    """Capon over the 8-element virtual array refines azimuth for detected
    cells, handling moving targets via TDM compensation."""
    targets = [
        SceneTarget(range_m=5.0, velocity_mps=3.0, azimuth_deg=22.0,
                    amplitude=2500.0),
    ]
    shorts = synthesize_capture(targets, 3, mcfg, noise_std=1.0, seed=37)
    pipe = RDPipeline(mcfg, max_detections=4)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    capon_az = pipe.capon_refine(
        jnp.asarray(shorts[1:]), base, out.doppler_bin, out.range_bin
    )
    assert capon_az.shape == out.azimuth_deg.shape
    for f in range(2):
        ks = [k for k in range(4) if bool(out.valid[f, k])]
        assert ks
        best = min(ks, key=lambda k: abs(float(out.range_m[f, k]) - 5.0))
        assert abs(float(capon_az[f, best]) - 22.0) <= 3.0, float(capon_az[f, best])


def test_capon_refine_single_tx(cfg):
    """Capon refinement also works on the plain 4-RX config."""
    targets = [SceneTarget(range_m=4.0, velocity_mps=0.0, azimuth_deg=-15.0,
                           amplitude=2500.0)]
    shorts = synthesize_capture(targets, 2, cfg, noise_std=1.0, seed=39)
    pipe = RDPipeline(cfg, max_detections=4)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    capon_az = pipe.capon_refine(
        jnp.asarray(shorts[1:]), base, out.doppler_bin, out.range_bin
    )
    ks = [k for k in range(4) if bool(out.valid[0, k])]
    best = min(ks, key=lambda k: abs(float(out.range_m[0, k]) - 4.0))
    assert abs(float(capon_az[0, best]) + 15.0) <= 5.0


class TestElevation:
    """Planar virtual arrays: one azimuth-offset TX replaced by an
    elevated TX enables joint (az, el) estimation."""

    def _cfg(self):
        from mmradar.config import RadarConfig

        # TX0 at origin, TX1 elevated by half a wavelength: virtual array
        # = two stacked 4-element ULAs -> az from the ULAs, el from the
        # inter-row phase
        return RadarConfig(num_tx=2, tx_positions_wl=((0.0, 0.0), (0.0, 0.5)))

    def test_steering_snapshot_recovers_az_el(self):
        from mmradar import golden
        from mmradar.ops.aoa import aoa_2d_from_snapshots

        cfg = self._cfg()
        assert cfg.has_elevation
        pos = cfg.virtual_positions_wl()
        az_t, el_t = 20.0, 12.0
        phase = 2 * np.pi * (
            pos[:, 0] * np.sin(np.deg2rad(az_t)) * np.cos(np.deg2rad(el_t))
            + pos[:, 1] * np.sin(np.deg2rad(el_t))
        )
        snap = np.exp(1j * phase)
        az_g, el_g = golden.aoa_2d(snap, cfg)
        az_j, el_j = aoa_2d_from_snapshots(
            jnp.asarray(snap, jnp.complex64)[None, None], cfg
        )
        # 4-element az aperture: coarse; elevation aperture 0.5wl: coarse
        assert abs(az_g - az_t) <= 6.0
        assert abs(el_g - el_t) <= 3.0
        assert abs(float(az_j[0, 0]) - az_g) <= 1.1  # grid-step agreement
        assert abs(float(el_j[0, 0]) - el_g) <= 1.1

    def test_pipeline_refine_2d_end_to_end(self):
        from mmradar.io.synthetic import SceneTarget, synthesize_capture
        from mmradar.models.rd_pipeline import RDPipeline

        cfg = self._cfg()
        tgt = SceneTarget(range_m=6.0, velocity_mps=1.0, azimuth_deg=-15.0,
                          elevation_deg=10.0, amplitude=3000.0)
        shorts = synthesize_capture([tgt], 3, cfg, noise_std=2.0, seed=61)
        pipe = RDPipeline(cfg, max_detections=4, rd_impl="fused",
                          cfar_impl="xla")
        base = pipe.prepare_base(jnp.asarray(shorts[0]))
        out = pipe.detect(jnp.asarray(shorts[1:]), base)
        az, el = pipe.refine_2d(
            jnp.asarray(shorts[1:]), base, out.doppler_bin, out.range_bin
        )
        # strongest detection per frame carries the target's angles
        az0 = float(np.asarray(az)[0, 0])
        el0 = float(np.asarray(el)[0, 0])
        assert bool(np.asarray(out.valid)[0, 0])
        assert abs(az0 - (-15.0)) <= 8.0
        assert abs(el0 - 10.0) <= 4.0

    def test_ula_elevation_degenerate(self, cfg):
        """With the default 1D ULA, has_elevation is False and the 2D scan
        returns boresight elevation (sanity guard, not a capability)."""
        assert not cfg.has_elevation


def test_azimuth_interpolation_beats_grid(cfg):
    """An off-grid azimuth: the sub-bin interpolated estimate lands closer
    to truth than the raw angle-FFT bin."""
    from statistics import median
    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar import golden

    az_true = 17.3  # between 64-bin angle-FFT grid points
    shorts = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=0.0, azimuth_deg=az_true,
                     amplitude=3000.0)],
        6, cfg, noise_std=2.0, seed=97,
    )
    pipe = RDPipeline(cfg, max_detections=4, rd_impl="fused", cfar_impl="xla")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    err_i, err_q = [], []
    for f in range(5):
        err_i.append(abs(float(out.azimuth_deg[f, 0]) - az_true))
        quant = golden.angle_bin_to_deg(
            int(out.angle_bin[f, 0]), cfg.num_angle_bins, cfg
        )
        err_q.append(abs(float(quant) - az_true))
    assert median(err_i) < 1.0
    assert median(err_i) < 0.7 * median(err_q)


def test_azimuth_interp_matches_golden_twin(cfg):
    """The jitted interpolated azimuth equals the float64 golden twin to
    f32 tolerance on a random snapshot."""
    from mmradar import golden
    from mmradar.models.rd_pipeline import aoa_from_snapshots

    rng = np.random.default_rng(99)
    snap = (rng.standard_normal(cfg.num_rx)
            + 1j * rng.standard_normal(cfg.num_rx))
    steer = np.exp(1j * 2 * np.pi * cfg.rx_spacing_wavelengths
                   * np.sin(np.deg2rad(21.7)) * np.arange(cfg.num_rx))
    snap = 5.0 * steer + 0.3 * snap
    want = golden.angle_fft_azimuth(snap, cfg)
    got, _ = aoa_from_snapshots(
        jnp.asarray(snap, jnp.complex64)[None, None], cfg
    )
    assert abs(float(got[0, 0]) - want) < 0.05
