"""MTI pulse-canceller clutter mode (``RadarConfig.clutter_mode``).

The reference's only clutter handling is base-frame subtraction
(cudaBenchMarking.cpp:277-280); 'mean' removes the scene average.
'mti2'/'mti3' notch zero Doppler per CPI with no empty-scene capture:
golden truth is :func:`mmradar.golden.mti_filter` (time domain, f64),
and every rd_impl must match it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.capture import decode_shorts
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import RDPipeline


class TestGoldenFilter:
    def test_static_sequence_rejected_exactly(self):
        rng = np.random.default_rng(0)
        static = rng.normal(size=(4, 1, 16)) + 1j * rng.normal(size=(4, 1, 16))
        x = np.broadcast_to(static, (4, 32, 16))  # constant along chirps
        for order in (2, 3):
            y = golden.mti_filter(x, order)
            assert np.abs(y).max() == 0.0  # exact, not approximate

    def test_definitions(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(8, 5)) + 1j * rng.normal(size=(8, 5))
        y2 = golden.mti_filter(x, 2)
        np.testing.assert_array_equal(y2, x - np.roll(x, 1, axis=-2))
        y3 = golden.mti_filter(x, 3)
        np.testing.assert_array_equal(
            y3, x - 2 * np.roll(x, 1, axis=-2) + np.roll(x, 2, axis=-2)
        )
        # TDM stride pairs same-TX chirps
        ys = golden.mti_filter(x, 2, stride=2)
        np.testing.assert_array_equal(ys, x - np.roll(x, 2, axis=-2))

    def test_bad_order(self):
        with pytest.raises(ValueError, match="order"):
            golden.mti_filter(np.zeros((4, 2)), 4)

    def test_jnp_twin_matches(self):
        from mmradar.ops.preproc import mti_clutter_removal

        rng = np.random.default_rng(2)
        x = rng.normal(size=(3, 16, 8)).astype(np.float32)
        for order in (2, 3):
            want = golden.mti_filter(x, order).real
            got = np.asarray(mti_clutter_removal(jnp.asarray(x), order))
            np.testing.assert_allclose(got, want, atol=1e-6)


class TestConfig:
    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError, match="clutter_mode"):
            RadarConfig(clutter_mode="mti4")

    def test_effective_clutter(self):
        cfg = RadarConfig()
        assert cfg.effective_clutter(True) == "base"
        assert cfg.effective_clutter(False) == "mean"
        cfg = RadarConfig(clutter_mode="mti2")
        assert cfg.effective_clutter(True) == "mti2"
        assert cfg.effective_clutter(False) == "mti2"
        with pytest.raises(ValueError, match="base cube"):
            RadarConfig(clutter_mode="base").effective_clutter(False)


@pytest.fixture(scope="module")
def mti_cfg() -> RadarConfig:
    return RadarConfig(clutter_mode="mti2")


@pytest.fixture(scope="module")
def mti_capture(mti_cfg) -> np.ndarray:
    """Strong STATIC clutter + two movers, no empty-scene base frame."""
    return synthesize_capture(
        [
            SceneTarget(range_m=6.0, velocity_mps=0.0, azimuth_deg=5.0,
                        amplitude=6000.0),
            SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                        amplitude=1200.0),
            SceneTarget(range_m=9.0, velocity_mps=-4.0, azimuth_deg=-30.0,
                        amplitude=1200.0),
        ],
        num_frames=3, cfg=mti_cfg, noise_std=2.0, seed=7,
    )


def _golden_power(shorts_frame, cfg, order):
    x64 = decode_shorts(shorts_frame, cfg)
    y = golden.mti_filter(x64, order, axis=-2, stride=cfg.num_tx)
    rd = golden.range_doppler_map(golden.virtual_cube(y, cfg), cfg)
    return np.sum(np.abs(rd) ** 2, axis=-3)


class TestParity:
    def test_rd_cube_matches_golden(self, mti_cfg, mti_capture):
        x64 = decode_shorts(mti_capture[1], mti_cfg)
        want = golden.range_doppler_map(
            golden.mti_filter(x64, 2, stride=mti_cfg.num_tx), mti_cfg
        )
        pipe = RDPipeline(mti_cfg)
        got = np.asarray(pipe.rd_cube(jnp.asarray(mti_capture[1]), None))
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-3

    def test_base_cube_ignored_in_mti_mode(self, mti_cfg, mti_capture):
        pipe = RDPipeline(mti_cfg)
        base = pipe.prepare_base(jnp.asarray(mti_capture[0]))
        with_base = np.asarray(
            pipe.rd_cube(jnp.asarray(mti_capture[1]), base)
        )
        without = np.asarray(pipe.rd_cube(jnp.asarray(mti_capture[1]), None))
        np.testing.assert_array_equal(with_base, without)

    def test_fused_planes_match_golden(self, mti_cfg, mti_capture):
        from mmradar.ops.fuseddft import fused_rd_planes

        dr, di = fused_rd_planes(jnp.asarray(mti_capture[1:2]), None, mti_cfg)
        got = np.asarray(dr) + 1j * np.asarray(di)
        x64 = decode_shorts(mti_capture[1], mti_cfg)
        want = golden.range_doppler_map(
            golden.mti_filter(x64, 2, stride=mti_cfg.num_tx), mti_cfg
        )
        scale = np.abs(want).max()
        assert np.abs(got[0] - want).max() / scale < 1e-3

    @pytest.mark.parametrize("order", [2, 3])
    def test_maps_power_matches_golden(self, mti_capture, order):
        """RDPipeline.maps on the raw-space 'fused' front-end: MTI power
        vs golden, and a hit map of the same shape."""
        cfg = RadarConfig(clutter_mode=f"mti{order}")
        power, hits = RDPipeline(cfg, rd_impl="fused",
                                 use_base_frame=False).maps(
            jnp.asarray(mti_capture[1:3]))
        want = _golden_power(mti_capture[1], cfg, order)
        got = np.asarray(power[0])
        scale = want.max()
        assert np.abs(got - want).max() / scale < 1e-3
        assert hits.shape == power.shape

    def test_fused_matches_fft_impl(self, mti_cfg, mti_capture):
        """The fused matmul front-end and the complex-FFT path agree
        bin-for-bin under MTI — same cross-impl gate as the other clutter
        modes."""
        shorts = jnp.asarray(mti_capture[1:3])
        a = RDPipeline(mti_cfg, rd_impl="fused").detect(shorts)
        b = RDPipeline(mti_cfg, rd_impl="fft").detect(shorts)
        np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
        va = np.asarray(a.valid)
        np.testing.assert_array_equal(
            np.asarray(a.range_bin)[va], np.asarray(b.range_bin)[va]
        )
        np.testing.assert_array_equal(
            np.asarray(a.doppler_bin)[va], np.asarray(b.doppler_bin)[va]
        )

    def test_snapshots_match_cube_gather(self, mti_cfg, mti_capture):
        """AoA snapshots gathered from the fused planes == from the
        complex-FFT RD cube under MTI."""
        from mmradar.models.rd_pipeline import gather_snapshots
        from mmradar.ops.fuseddft import fused_rd_planes

        shorts = jnp.asarray(mti_capture[1:2])
        top_idx = jnp.asarray([[513, 2048, 77]], jnp.int32)
        rd = RDPipeline(mti_cfg, rd_impl="fft").rd_cube(shorts, None)
        got = np.asarray(gather_snapshots(rd, top_idx))
        dr, di = fused_rd_planes(shorts, None, mti_cfg)
        want = np.asarray(
            gather_snapshots(dr, top_idx) + 1j * gather_snapshots(di, top_idx)
        )
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


class TestFunctional:
    def test_static_clutter_suppressed_movers_kept(self, mti_cfg, mti_capture):
        """6 m static return 5x the movers' amplitude, no base frame:
        MTI keeps both movers and drops the static blob."""
        pipe = RDPipeline(mti_cfg, max_detections=8, use_base_frame=False)
        out = pipe.detect(jnp.asarray(mti_capture[1:]))
        dets = [
            (float(out.range_m[0, k]), float(out.velocity_mps[0, k]))
            for k in range(8) if bool(out.valid[0, k])
        ]
        assert any(abs(r - 3.0) < 1.0 and abs(v - 2.0) < 1.0 for r, v in dets)
        assert any(abs(r - 9.0) < 1.0 and abs(v + 4.0) < 1.0 for r, v in dets)
        # the static target sits in the Doppler notch: no near-zero-velocity
        # detection at its range
        assert not any(
            abs(r - 6.0) < 0.5 and abs(v) < 0.5 for r, v in dets
        )

    def test_cli_serve_mti(self, mti_cfg, mti_capture, serve_over_udp):
        """Live serving under MTI: movers served, the 5x static blob
        suppressed, no empty-scene base needed (frame 0 still primes the
        base slot but the mode ignores it)."""
        recs = serve_over_udp(mti_capture[:4], ["--clutter", "mti2"])
        dets = [d for r in recs if "frame" in r for d in r["detections"]]
        assert any(abs(d["range_m"] - 9.0) < 1.0 and
                   abs(d["velocity_mps"] + 4.0) < 1.0 for d in dets)
        assert not any(abs(d["range_m"] - 6.0) < 0.5 and
                       abs(d["velocity_mps"]) < 0.5 for d in dets)

    def test_cli_detect_clutter_flag(self, tmp_path, mti_capture, capsys):
        import json

        from mmradar import cli
        from mmradar.io.capture import write_capture

        cap = tmp_path / "mti.bin"
        write_capture(str(cap), mti_capture)
        out = tmp_path / "dets.jsonl"
        rc = cli.main([
            "detect", str(cap), "--full", "--clutter", "mti2",
            "--out", str(out),
        ])
        assert rc == 0
        recs = [json.loads(l) for l in out.read_text().splitlines()]
        dets = [d for r in recs for d in r.get("detections", [])]
        assert any(abs(d["range_m"] - 9.0) < 1.0 for d in dets)


def test_distributed_mti_matches_single_device(mti_cfg, mti_capture):
    """chan-sharded mesh under MTI agrees with the single-device FFT path."""
    import jax

    from mmradar.parallel.distributed import DistributedRDPipeline
    from mmradar.parallel.mesh import build_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = build_mesh(n_devices=8, num_rx=mti_cfg.num_rx)
    shorts = np.broadcast_to(
        mti_capture[1], (2, mti_capture.shape[1])
    ).copy()
    ref = RDPipeline(mti_cfg, rd_impl="fft", max_detections=8).detect(
        jnp.asarray(shorts)
    )
    va = np.asarray(ref.valid)
    # both the fft shard path and the chan-sharded fused path (which
    # applies the canceller to each shard's range planes)
    for rd_impl in ("fft", "fused"):
        dist = DistributedRDPipeline(cfg=mti_cfg, mesh=mesh,
                                     max_detections=8, rd_impl=rd_impl,
                                     cfar_impl="auto")
        base = dist.prepare_base(mti_capture[0])
        out = dist.detect(dist.shard_frames(shorts), base)
        np.testing.assert_array_equal(np.asarray(out.valid), va)
        np.testing.assert_array_equal(
            np.asarray(out.range_bin)[va], np.asarray(ref.range_bin)[va]
        )
    # MTI is base-free: detect(None) is accepted and identical
    no_base = dist.detect(dist.shard_frames(shorts), None)
    np.testing.assert_array_equal(np.asarray(no_base.valid), va)
    # ... but 'auto' without a base must refuse (a zero base would
    # silently disable clutter removal at the shard level)
    from mmradar.config import RadarConfig

    auto = DistributedRDPipeline(cfg=RadarConfig(), mesh=mesh,
                                 max_detections=8)
    with pytest.raises(ValueError, match="base-free clutter_mode"):
        auto.detect(dist.shard_frames(shorts), None)
