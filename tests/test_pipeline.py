"""End-to-end pipeline integration tests vs the golden model.

This is the promoted version of the reference's disabled CPU<->CUDA
verification loop (cudaBenchMarking.cpp:410-419): golden float64 trace vs
device pipeline per frame — detection indices exact, magnitudes/distances
within 1e-3 relative (BASELINE.json gates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.capture import encode_frame
from mmradar.io.synthetic import SceneTarget, synthesize_capture, synthesize_cube
from mmradar.models.range_detector import RangeDetector
from mmradar.models.rd_pipeline import RDPipeline


class TestRangeDetector:
    def test_matches_golden_on_capture(self, cfg, capture):
        det = RangeDetector(cfg)
        out = det.detect_capture(capture)
        want = golden.detect_capture(capture, cfg)
        assert out.peak_bin.shape == (len(want),)
        for i, w in enumerate(want):
            assert int(out.peak_bin[i]) == w.peak_bin, f"frame {i}"
            assert int(out.rescaled_bin[i]) == w.rescaled_bin
            assert abs(float(out.distance_m[i]) - w.distance_m) <= 1e-3 * max(
                w.distance_m, 1e-9
            )
            assert (
                abs(float(out.peak_magnitude[i]) - w.peak_magnitude)
                <= 1e-3 * w.peak_magnitude
            )

    def test_single_frame_unbatched(self, cfg, capture):
        det = RangeDetector(cfg)
        base = det.prepare_base(jnp.asarray(capture[0]))
        out = det.detect(jnp.asarray(capture[1]), base)
        w = golden.detect_capture(capture[:2], cfg)[0]
        assert int(out.peak_bin) == w.peak_bin
        assert out.peak_bin.shape == ()

    def test_deterministic(self, cfg, capture):
        det = RangeDetector(cfg)
        a = det.detect_capture(capture)
        b = det.detect_capture(capture)
        np.testing.assert_array_equal(np.asarray(a.peak_bin), np.asarray(b.peak_bin))
        np.testing.assert_array_equal(
            np.asarray(a.peak_magnitude), np.asarray(b.peak_magnitude)
        )

    def test_multi_range_sweep(self, cfg):
        """Targets across the unambiguous range land on the right bins."""
        det = RangeDetector(cfg)
        for r_true in [1.5, 4.0, 9.0, 15.0]:
            shorts = synthesize_capture(
                [SceneTarget(range_m=r_true, amplitude=3000.0)],
                3, cfg, noise_std=5.0, seed=int(r_true * 10),
            )
            out = det.detect_capture(shorts)
            for i in range(2):
                phys = cfg.bin_to_physical_distance(int(out.peak_bin[i]))
                assert abs(phys - r_true) < 0.6, (r_true, phys)


class TestRDPipeline:
    def test_detects_targets_with_kinematics(self, cfg, targets):
        shorts = synthesize_capture(targets, 4, cfg, noise_std=2.0, seed=42)
        pipe = RDPipeline(cfg, max_detections=8)
        base = pipe.prepare_base(jnp.asarray(shorts[0]))
        out = pipe.detect(jnp.asarray(shorts[1:]), base)

        assert out.range_bin.shape == (3, 8)
        for f in range(3):
            vals = [
                (float(out.range_m[f, k]), float(out.velocity_mps[f, k]),
                 float(out.azimuth_deg[f, k]))
                for k in range(8) if bool(out.valid[f, k])
            ]
            assert len(vals) >= 2, f"frame {f} found {len(vals)} detections"
            for tgt in targets:
                # target moves between frames; allow generous gates
                best = min(vals, key=lambda v: abs(v[0] - tgt.range_m))
                assert abs(best[0] - tgt.range_m) < 1.0
                assert abs(best[1] - tgt.velocity_mps) < 1.0
                assert abs(best[2] - tgt.azimuth_deg) < 12.0

    def test_rd_map_matches_golden(self, cfg, targets):
        cube = synthesize_cube(targets, 3, cfg, noise_std=1.0, seed=42)
        from mmradar.io.capture import decode_shorts

        x64 = decode_shorts(encode_frame(cube[1], cfg), cfg) - cube[0]
        want = golden.range_doppler_map(x64, cfg)
        pipe = RDPipeline(cfg)
        got = np.asarray(
            pipe.rd_cube(
                jnp.asarray(encode_frame(cube[1], cfg)),
                jnp.asarray(cube[0].astype(np.complex64)),
            )
        )
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-3

    def test_mean_clutter_mode(self, cfg, targets):
        """Without a base frame the pipeline falls back to mean removal and
        still finds moving targets."""
        shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=1)
        pipe = RDPipeline(cfg, max_detections=8, use_base_frame=False)
        out = pipe.detect(jnp.asarray(shorts[1:]))
        ranges = [
            float(out.range_m[0, k]) for k in range(8) if bool(out.valid[0, k])
        ]
        assert any(abs(r - 3.0) < 1.0 for r in ranges)
        assert any(abs(r - 8.0) < 1.0 for r in ranges)


class TestCfarImplSwitch:
    def test_auto_matches_xla(self, cfg, targets):
        shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=9)
        a = RDPipeline(cfg, max_detections=8, cfar_impl="xla")
        b = RDPipeline(cfg, max_detections=8, cfar_impl="auto")
        base_a = a.prepare_base(jnp.asarray(shorts[0]))
        out_a = a.detect(jnp.asarray(shorts[1:]), base_a)
        out_b = b.detect(jnp.asarray(shorts[1:]), base_a)
        np.testing.assert_array_equal(
            np.asarray(out_a.range_bin), np.asarray(out_b.range_bin)
        )
        np.testing.assert_array_equal(
            np.asarray(out_a.num_hits), np.asarray(out_b.num_hits)
        )


class TestParityStress:
    def test_exact_bin_match_across_many_scenes(self, cfg):
        """20 random scenes: detection indices must match golden exactly
        (the BASELINE gate), across ranges, SNRs and multi-target mixes."""
        rng = np.random.default_rng(99)
        det = RangeDetector(cfg)
        for trial in range(20):
            n_tgt = int(rng.integers(1, 4))
            tgts = [
                SceneTarget(
                    range_m=float(rng.uniform(1.0, 18.0)),
                    velocity_mps=float(rng.uniform(-5, 5)),
                    azimuth_deg=float(rng.uniform(-50, 50)),
                    amplitude=float(rng.uniform(800, 4000)),
                )
                for _ in range(n_tgt)
            ]
            shorts = synthesize_capture(
                tgts, 3, cfg, noise_std=float(rng.uniform(1, 20)), seed=trial
            )
            out = det.detect_capture(shorts)
            want = golden.detect_capture(shorts, cfg)
            for i, w in enumerate(want):
                assert int(out.peak_bin[i]) == w.peak_bin, (trial, i)
                assert float(out.peak_magnitude[i]) == pytest.approx(
                    w.peak_magnitude, rel=1e-3
                )

    def test_rd_pipeline_deterministic(self, cfg, targets):
        shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=8)
        pipe = RDPipeline(cfg, max_detections=8)
        base = pipe.prepare_base(jnp.asarray(shorts[0]))
        a = pipe.detect(jnp.asarray(shorts[1:]), base)
        b = pipe.detect(jnp.asarray(shorts[1:]), base)
        for la, lb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_rd_pipeline_unbatched_frame(cfg, targets):
    """A single unbatched frame (serving path) produces the same result as
    a batch of one."""
    shorts = synthesize_capture(targets, 2, cfg, noise_std=2.0, seed=12)
    pipe = RDPipeline(cfg, max_detections=8)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    batched = pipe.detect(jnp.asarray(shorts[1:2]), base)
    single = pipe.detect(jnp.asarray(shorts[1])[None], base)
    np.testing.assert_array_equal(
        np.asarray(batched.range_bin), np.asarray(single.range_bin)
    )


def test_pipeline_classes_frozen_and_value_hashed():
    """self is a jit static argument: freezing prevents the silent
    stale-compilation reuse a mutable self would allow, and value hashing
    makes identically-configured pipelines share one compiled program."""
    import dataclasses

    cfg = RadarConfig()
    pipe = RDPipeline(cfg, max_detections=8)
    with pytest.raises(dataclasses.FrozenInstanceError):
        pipe.cfar_impl = "xla"
    det = RangeDetector(cfg)
    with pytest.raises(dataclasses.FrozenInstanceError):
        det.detect_impl = "xla"

    # equal config -> equal hash -> shared jit cache entry
    assert RDPipeline(cfg, max_detections=8) == pipe
    assert hash(RDPipeline(cfg, max_detections=8)) == hash(pipe)
    assert RDPipeline(cfg, max_detections=8, cfar_impl="xla") != pipe
    assert RangeDetector(cfg) == det


def test_planar_pipeline_matches_mxu(cfg, targets):
    """The planar end-to-end path performs the identical real arithmetic
    as rd_impl='mxu' (which splits planes at the matmul); results must
    match to float32 roundoff, detections exactly."""
    shorts = synthesize_capture(targets, 4, cfg, noise_std=2.0, seed=21)
    mxu = RDPipeline(cfg, max_detections=8, rd_impl="mxu", cfar_impl="xla")
    planar = RDPipeline(cfg, max_detections=8, rd_impl="planar",
                        cfar_impl="xla")
    base = mxu.prepare_base(jnp.asarray(shorts[0]))
    a = mxu.detect(jnp.asarray(shorts[1:]), base)
    b = planar.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.doppler_bin), np.asarray(b.doppler_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_array_equal(np.asarray(a.angle_bin), np.asarray(b.angle_bin))
    np.testing.assert_array_equal(np.asarray(a.num_hits), np.asarray(b.num_hits))
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.azimuth_deg),
                               np.asarray(b.azimuth_deg), rtol=1e-5, atol=1e-4)


def test_planar_pipeline_mean_clutter_and_golden(cfg, targets):
    """Planar path without a base frame (mean clutter removal) matches the
    complex-cube mxu path, and still finds the targets."""
    shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=22)
    mxu = RDPipeline(cfg, max_detections=8, use_base_frame=False,
                     rd_impl="mxu", cfar_impl="xla")
    planar = RDPipeline(cfg, max_detections=8, use_base_frame=False,
                        rd_impl="planar", cfar_impl="xla")
    a = mxu.detect(jnp.asarray(shorts[1:]))  # frame 0 = empty scene
    b = planar.detect(jnp.asarray(shorts[1:]))
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    assert np.asarray(b.num_hits).min() > 0


@pytest.mark.parametrize("use_base", [True, False])
def test_fused_pipeline_matches_mxu(cfg, targets, use_base):
    """The fused interleave-matmul path (decode+window+DFT folded into
    the matmul contractions, ops/fuseddft.py) must agree with the
    complex-cube mxu path: detections exactly, power to f32 roundoff."""
    shorts = synthesize_capture(targets, 4, cfg, noise_std=2.0, seed=33)
    mxu = RDPipeline(cfg, max_detections=8, rd_impl="mxu", cfar_impl="xla",
                     use_base_frame=use_base)
    fused = RDPipeline(cfg, max_detections=8, rd_impl="fused",
                       cfar_impl="xla", use_base_frame=use_base)
    base = mxu.prepare_base(jnp.asarray(shorts[0])) if use_base else None
    a = mxu.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.doppler_bin), np.asarray(b.doppler_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_array_equal(np.asarray(a.angle_bin), np.asarray(b.angle_bin))
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4, atol=1e-2)


def test_fused_pipeline_mimo(targets):
    """Fused path with TDM-MIMO (num_tx=2): virtual array ordering and the
    chirp de-multiplex inside the Doppler contraction must match the
    explicit virtualize_cube path."""
    from mmradar.config import RadarConfig as RC

    cfg2 = RC(num_tx=2)
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=34)
    mxu = RDPipeline(cfg2, max_detections=8, rd_impl="mxu", cfar_impl="xla")
    fused = RDPipeline(cfg2, max_detections=8, rd_impl="fused",
                       cfar_impl="xla")
    base = mxu.prepare_base(jnp.asarray(shorts[0]))
    a = mxu.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_array_equal(np.asarray(a.angle_bin), np.asarray(b.angle_bin))
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4, atol=1e-2)


def test_detect_donated_matches_and_consumes(cfg, targets):
    """detect_donated == detect, and the donated input buffer is actually
    consumed (deleted) by the call."""
    shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=41)
    pipe = RDPipeline(cfg, max_detections=8, rd_impl="planar", cfar_impl="xla")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    want = pipe.detect(jnp.asarray(shorts[1:]), base)
    buf = jax.device_put(shorts[1:])
    got = pipe.detect_donated(buf, base)
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    # on the CPU backend XLA declines the donation (outputs are far smaller
    # than the input, nothing to alias) and leaves the buffer live; on an
    # accelerator the buffer may be consumed.  Either way the call
    # semantics must hold.
    assert buf.is_deleted() or jax.default_backend() == "cpu"


@pytest.mark.parametrize("impl", ["fused", "fft", "mxu", "planar"])
def test_unbatched_frame_all_impls(cfg, targets, impl):
    """A single unbatched (S,) frame must work on every rd_impl — the
    fused paths briefly hardcoded one batch dim."""
    shorts = synthesize_capture(targets, 2, cfg, noise_std=2.0, seed=71)
    pipe = RDPipeline(cfg, max_detections=8, rd_impl=impl, cfar_impl="xla")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    batched = pipe.detect(jnp.asarray(shorts[1:2]), base)
    single = pipe.detect(jnp.asarray(shorts[1]), base)
    np.testing.assert_array_equal(
        np.asarray(batched.range_bin[0]), np.asarray(single.range_bin)
    )


def test_os_kind_hits_only_matches_threshold_path(cfg):
    """OS-CFAR through the pipeline's CFAR dispatch: the hits-only path
    (the counting form, what detection runs) gives the hit map of the
    threshold path (the sort form), bit for bit."""
    from mmradar.config import RadarConfig as RC

    rng = np.random.default_rng(9)
    power = jnp.asarray(
        rng.gamma(2.0, 100.0, (2, 128, 128)).astype(np.float32)
    )
    pipe = RDPipeline(RC(cfar_kind="os"), max_detections=8, cfar_impl="xla")
    hits_a, thr_a = pipe._cfar(power)
    hits_b, thr_b = pipe._cfar(power, hits_only=True)
    assert thr_b is None and thr_a.shape == power.shape
    np.testing.assert_array_equal(np.asarray(hits_a), np.asarray(hits_b))


def test_range_interpolation_beats_bin_quantization(cfg):
    """A target placed OFF the ~39 cm range grid: the parabolic sub-bin
    estimate must land much closer to truth than the quantized bin."""
    from statistics import median

    r_true = 5.17  # between bins (bin width c*Fs/R/(2*mu) ~= 0.3915 m)
    shorts = synthesize_capture(
        [SceneTarget(range_m=r_true, velocity_mps=0.0, azimuth_deg=0.0,
                     amplitude=3000.0)],
        6, cfg, noise_std=2.0, seed=91,
    )
    pipe = RDPipeline(cfg, max_detections=4, rd_impl="fused", cfar_impl="xla")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    # strongest detection per frame
    err_q = [abs(float(out.range_m[f, 0]) - r_true) for f in range(5)]
    err_i = [abs(float(out.range_m_interp[f, 0]) - r_true) for f in range(5)]
    assert median(err_i) < 0.06               # few-cm accuracy
    assert median(err_i) < 0.5 * median(err_q)  # beats quantization


def test_velocity_interpolation_beats_bin_quantization(cfg):
    """Velocity off the Doppler grid (~0.24 m/s bins): sub-bin estimate
    closer to truth than the quantized bin."""
    from statistics import median

    v_true = 2.31  # between Doppler bins
    shorts = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=v_true, azimuth_deg=0.0,
                     amplitude=3000.0)],
        6, cfg, noise_std=2.0, seed=95,
    )
    pipe = RDPipeline(cfg, max_detections=4, rd_impl="fused", cfar_impl="xla")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    err_q = [abs(float(out.velocity_mps[f, 0]) - v_true) for f in range(5)]
    err_i = [abs(float(out.velocity_mps_interp[f, 0]) - v_true)
             for f in range(5)]
    assert median(err_i) < 0.05
    assert median(err_i) < 0.6 * median(err_q)


def test_range_interp_matches_golden_offset():
    """The jnp interpolation math is the twin of golden.parabolic_bin_offset."""
    from mmradar.golden import parabolic_bin_offset
    from mmradar.models.rd_pipeline import interp_cell_physics

    cfg = RadarConfig()
    rng = np.random.default_rng(93)
    power = rng.exponential(1.0, (1, cfg.doppler_fft_size,
                                  cfg.range_fft_size)).astype(np.float32)
    power[0, 30, 50:53] = [100.0, 400.0, 250.0]
    top_idx = np.array([[30 * cfg.range_fft_size + 51]], np.int32)
    got, _ = interp_cell_physics(jnp.asarray(power), jnp.asarray(top_idx),
                                 jnp.asarray([[30]]), jnp.asarray([[51]]), cfg)
    off = parabolic_bin_offset(np.float64(100.0), 400.0, 250.0)
    scale = cfg.sample_rate_hz / cfg.range_fft_size
    want = (51 + off) * scale * 3e8 / (2 * cfg.slope_hz_per_s)
    np.testing.assert_allclose(float(got[0, 0]), want, rtol=1e-5)


def test_range_interp_zero_offset_at_map_edges():
    """Edge range cells have no sub-bin information: a clamped neighbor
    must NOT produce the spurious ±0.5 offset the raw parabola gives."""
    from mmradar.models.rd_pipeline import interp_cell_physics

    cfg = RadarConfig()
    r_size = cfg.range_fft_size
    power = np.ones((1, cfg.doppler_fft_size, r_size), np.float32)
    power[0, 10, 0] = 500.0     # peak at range bin 0
    power[0, 20, r_size - 1] = 500.0  # peak at the last bin
    top = np.array([[10 * r_size + 0, 20 * r_size + r_size - 1]], np.int32)
    rng, _ = interp_cell_physics(
        jnp.asarray(power), jnp.asarray(top),
        jnp.asarray([[10, 20]]), jnp.asarray([[0, r_size - 1]]), cfg,
    )
    scale = cfg.sample_rate_hz / cfg.range_fft_size * 3e8 / (2 * cfg.slope_hz_per_s)
    np.testing.assert_allclose(np.asarray(rng)[0], [0.0, (r_size - 1) * scale],
                               rtol=1e-6)
    assert float(rng[0, 0]) >= 0.0  # never negative range


def test_onchip_time_harness(cfg, capture):
    """The shared on-chip timing harness (utils.timing.onchip_time) must
    execute its fori_loop program and return a non-negative per-iteration
    time — scripts/frontend_ab.py leans on it."""
    import jax.numpy as jnp

    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.utils.timing import onchip_time

    pipe = RDPipeline(cfg, max_detections=8, rd_impl="fused")
    base = pipe.prepare_base(jnp.asarray(capture[0]))
    shorts = jnp.asarray(capture[1:3])
    dt = onchip_time(pipe.detect, shorts, base, iters=2, reps=1)
    assert dt >= 0.0


def test_range_edge_guard_masks_wrapped_sidelobes():
    """A strong near-range target's Hann sidelobes wrap circularly
    through DC into the top range bins, where 'reflect' CFAR training
    never sees the peak — persistent ghosts at the design Pfa (measured
    -69 dB at 12 circular bins from this 77 dB-SNR scene).  The default
    range_edge_guard masks them; guard=0 reproduces the raw behavior so
    the phenomenon itself stays gated."""
    import dataclasses

    import jax.numpy as jnp

    from mmradar.config import RadarConfig
    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline

    cfg = RadarConfig()
    cap = synthesize_capture([SceneTarget(4.0, 1.5, 10.0)], 4, cfg,
                             noise_std=10.0, seed=3)
    cut = cfg.range_fft_size - cfg.range_edge_guard_effective

    def edge_detections(c):
        pipe = RDPipeline(c, max_detections=16)
        base = pipe.prepare_base(jnp.asarray(cap[0]))
        out = pipe.detect(jnp.asarray(cap[1:]), base)
        rb = np.asarray(out.range_bin)
        return int((np.asarray(out.valid) & (rb >= cut)).sum())

    raw = edge_detections(dataclasses.replace(cfg, range_edge_guard=0))
    assert raw > 0, "expected wrapped-sidelobe ghosts with the guard off"
    assert edge_detections(cfg) == 0
