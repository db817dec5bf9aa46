"""Cross-configuration robustness: alternate radar geometries through the
full pipelines with golden parity (BASELINE config 1 mentions 256-sample
captures; the framework must not be hardwired to the reference's 100x128)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.range_detector import RangeDetector
from mmradar.models.rd_pipeline import RDPipeline

CONFIGS = [
    RadarConfig(num_samples=256, num_chirps=128),           # config-1 shape
    RadarConfig(num_samples=128, num_chirps=32),            # pow2 fast path
    RadarConfig(num_samples=64, num_chirps=64, num_rx=2),   # small array
    RadarConfig(num_samples=100, num_chirps=64, num_tx=2),  # MIMO variant
]


@pytest.mark.parametrize("c", CONFIGS, ids=lambda c: (
    f"s{c.num_samples}-c{c.num_chirps}-rx{c.num_rx}-tx{c.num_tx}"
))
def test_range_parity_across_configs(c):
    shorts = synthesize_capture(
        [SceneTarget(range_m=4.0, amplitude=3000.0)], 3, c,
        noise_std=3.0, seed=len(CONFIGS),
    )
    det = RangeDetector(c)
    out = det.detect_capture(shorts)
    want = golden.detect_capture(shorts, c)
    for i, w in enumerate(want):
        assert int(out.peak_bin[i]) == w.peak_bin
        assert float(out.distance_m[i]) == pytest.approx(w.distance_m, rel=1e-3)


@pytest.mark.parametrize("c", CONFIGS, ids=lambda c: (
    f"s{c.num_samples}-c{c.num_chirps}-rx{c.num_rx}-tx{c.num_tx}"
))
def test_rd_pipeline_across_configs(c):
    tgt = SceneTarget(range_m=4.0, velocity_mps=1.5, azimuth_deg=12.0,
                      amplitude=3000.0)
    shorts = synthesize_capture([tgt], 3, c, noise_std=2.0, seed=7)
    pipe = RDPipeline(c, max_detections=8)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    for f in range(2):
        vals = [
            (float(out.range_m[f, k]), float(out.velocity_mps[f, k]))
            for k in range(8) if bool(out.valid[f, k])
        ]
        assert vals, f"no detections in frame {f}"
        best = min(vals, key=lambda v: abs(v[0] - 4.0))
        assert abs(best[0] - 4.0) < 1.2
        assert abs(best[1] - 1.5) < 1.2


def test_invalid_configs_rejected():
    with pytest.raises(ValueError):
        RadarConfig(num_chirps=100, num_tx=3).chirps_per_tx


def test_rescale_no_int32_overflow():
    """peak_bin * rx_samples overflows int32 for big configs; the device
    rescale must still match Python's exact integer math."""
    import jax.numpy as jnp

    from mmradar.ops.detect import distance_from_bin

    for c in [
        RadarConfig(num_samples=256, num_chirps=512),   # rx=131072 (pow2)
        RadarConfig(num_samples=250, num_chirps=512),   # rx=128000, fft=131072
        RadarConfig(num_samples=200, num_chirps=400),   # rx=80000, fft=131072
    ]:
        bins = np.unique(
            np.concatenate([
                np.linspace(0, c.scan_bins - 1, 50, dtype=np.int64),
                [0, 1, c.scan_bins - 1],
            ])
        )
        rescaled, dist = distance_from_bin(jnp.asarray(bins, jnp.int32), c)
        want = [c.rescale_peak_bin(int(b)) for b in bins]
        np.testing.assert_array_equal(np.asarray(rescaled), want)
        assert float(np.asarray(dist).min()) >= 0.0


@pytest.mark.parametrize("c", CONFIGS, ids=lambda c: (
    f"s{c.num_samples}-c{c.num_chirps}-rx{c.num_rx}-tx{c.num_tx}"
))
def test_fused_matches_mxu_across_configs(c):
    """The interleave-matmul fused path must agree with the complex-cube
    mxu path at every geometry, not just the reference's 100x128x4."""
    tgt = SceneTarget(range_m=4.0, velocity_mps=1.5, azimuth_deg=12.0,
                      amplitude=3000.0)
    shorts = synthesize_capture([tgt], 3, c, noise_std=2.0, seed=9)
    mxu = RDPipeline(c, max_detections=8, rd_impl="mxu", cfar_impl="xla")
    fused = RDPipeline(c, max_detections=8, rd_impl="fused", cfar_impl="xla")
    base = mxu.prepare_base(jnp.asarray(shorts[0]))
    a = mxu.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4, atol=1e-2)


@pytest.mark.parametrize("seed", range(6))
def test_fused_matches_mxu_random_geometry(seed):
    """Fuzz: random (even-sample) geometries through fused vs mxu — the
    interleave-matmul construction must hold for arbitrary shapes, not
    just the curated CONFIGS list."""
    rng = np.random.RandomState(seed + 100)
    num_tx = int(rng.choice([1, 2]))
    c = RadarConfig(
        num_samples=int(rng.choice([24, 48, 72, 100, 160])),
        num_chirps=int(rng.choice([16, 32, 48, 64])) * num_tx,
        num_rx=int(rng.choice([2, 4])),
        num_tx=num_tx,
    )
    tgt = SceneTarget(range_m=3.5, velocity_mps=1.0, azimuth_deg=8.0,
                      amplitude=3000.0)
    shorts = synthesize_capture([tgt], 2, c, noise_std=2.0, seed=seed)
    mxu = RDPipeline(c, max_detections=4, rd_impl="mxu", cfar_impl="xla")
    fused = RDPipeline(c, max_detections=4, rd_impl="fused", cfar_impl="xla")
    base = mxu.prepare_base(jnp.asarray(shorts[0]))
    a = mxu.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4, atol=1e-2)


def test_invalid_knob_values_rejected():
    """Enum/count knobs fail at construction, not as three silently
    different detectors across the golden/XLA/C++ twins."""
    with pytest.raises(ValueError, match="cfar_os_stride"):
        RadarConfig(cfar_os_stride=-2)
    with pytest.raises(ValueError, match="cfar_os_stride"):
        RadarConfig(cfar_os_stride=0)
    with pytest.raises(ValueError, match="cfar_kind"):
        RadarConfig(cfar_kind="osca")
    with pytest.raises(ValueError, match="cfar_range_mode"):
        RadarConfig(cfar_range_mode="clamp")
    with pytest.raises(ValueError, match="dft_precision"):
        RadarConfig(dft_precision="bf16")
    with pytest.raises(ValueError, match="cfar_os_k_frac"):
        RadarConfig(cfar_os_k_frac=0.0)


@pytest.mark.parametrize("c", CONFIGS, ids=lambda c: (
    f"s{c.num_samples}-c{c.num_chirps}-rx{c.num_rx}-tx{c.num_tx}"
))
def test_fft_matches_fused_across_configs(c):
    """The FFT front-end (the auto default) must agree with the fused
    matmul path at every geometry — the reshape/demux math is
    shape-generic, not hardwired to 100x128x4."""
    tgt = SceneTarget(range_m=4.0, velocity_mps=1.5, azimuth_deg=12.0,
                      amplitude=3000.0)
    shorts = synthesize_capture([tgt], 3, c, noise_std=2.0, seed=11)
    fused = RDPipeline(c, max_detections=8, rd_impl="fused", cfar_impl="xla")
    fft = RDPipeline(c, max_detections=8, rd_impl="fft", cfar_impl="xla")
    base = fused.prepare_base(jnp.asarray(shorts[0]))
    a = fused.detect(jnp.asarray(shorts[1:]), base)
    b = fft.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    # atol scaled to the peak: noise-floor cells (~1e-7 of peak) carry
    # clutter-cancellation noise that differs between the FFT and the
    # matmul accumulation orders
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4,
                               atol=1e-8 * float(np.asarray(a.power).max()))


@pytest.mark.parametrize("seed", range(4))
def test_fft_matches_fused_random_geometry(seed):
    """Fuzz the FFT front-end against the fused one across random
    geometries."""
    rng = np.random.RandomState(seed + 200)
    num_tx = int(rng.choice([1, 2]))
    c = RadarConfig(
        num_samples=int(rng.choice([24, 48, 72, 100])),
        num_chirps=int(rng.choice([16, 32, 48])) * num_tx,
        num_rx=int(rng.choice([2, 4])),
        num_tx=num_tx,
    )
    tgt = SceneTarget(range_m=3.5, velocity_mps=1.0, azimuth_deg=8.0,
                      amplitude=3000.0)
    shorts = synthesize_capture([tgt], 2, c, noise_std=2.0, seed=seed)
    fused = RDPipeline(c, max_detections=4, rd_impl="fused", cfar_impl="xla")
    fft = RDPipeline(c, max_detections=4, rd_impl="fft", cfar_impl="xla")
    base = fused.prepare_base(jnp.asarray(shorts[0]))
    a = fused.detect(jnp.asarray(shorts[1:]), base)
    b = fft.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin), np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    # atol scaled to the peak: noise-floor cells (~1e-7 of peak) carry
    # clutter-cancellation noise that differs between the FFT and the
    # matmul accumulation orders
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4,
                               atol=1e-8 * float(np.asarray(a.power).max()))
