"""Keystone range-migration compensation (ops/keystone.py).

The test geometry makes intra-CPI walk DECISIVE where the default
geometry's is sub-cell: 4x the reference slope (range cell 0.098 m) and
512 chirps (CPI 32.8 ms), so a 10 m/s target walks ~3.3 range cells
within one CPI — the peak smears across both axes, and the keystone
transform refocuses it exactly (measured 2.66x peak-power recovery to
1.0000 of the no-migration ideal at f64).

The generator's ``chirp_level_motion`` flag provides the physics: the
beat frequency follows R(t) per chirp instead of per frame (the default
keeps every existing capture byte-identical).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_cube, encode_frame
from mmradar.ops.keystone import keystone_cube


WALK_CFG = RadarConfig(num_chirps=512, slope_hz_per_s=4 * 5.987e12)


def _rd_power(cube, cfg):
    """f64 windowed RD power, RX-integrated (reference check path)."""
    w = np.hanning(cfg.num_samples)
    r = np.fft.fft(cube * w, n=cfg.range_fft_size, axis=-1)
    d = np.fft.fftshift(np.fft.fft(r, n=cfg.doppler_fft_size, axis=-2),
                        axes=-2)
    return (np.abs(d) ** 2).sum(axis=-3)


def _walk_cube(v=10.0, cfg=WALK_CFG, **kw):
    tgt = [SceneTarget(range_m=5.0, velocity_mps=v, azimuth_deg=0.0,
                       amplitude=1000.0)]
    return synthesize_cube(tgt, 2, cfg, noise_std=0.0,
                           clutter_amplitude=0.0, seed=0,
                           chirp_level_motion=True, **kw)[1]


def test_walk_geometry_is_decisive():
    """The chosen config actually produces multi-cell intra-CPI walk."""
    cfg = WALK_CFG
    r_res = ((cfg.sample_rate_hz / cfg.range_fft_size) * 3e8
             / (2 * cfg.slope_hz_per_s))
    walk = 10.0 * cfg.num_chirps * cfg.chirp_interval_s / r_res
    assert walk > 3.0
    # and the test velocity is unambiguous (keystone's validity domain)
    assert 10.0 < cfg.wavelength_m / (4 * cfg.chirp_interval_s)


def test_keystone_refocuses_to_ideal():
    """Keystone recovers the full no-migration peak power at the right
    cell: smeared peak < 0.45x ideal, keystone peak within 0.1% of it."""
    cfg = WALK_CFG
    cube = _walk_cube()
    tgt = [SceneTarget(range_m=5.0, velocity_mps=10.0, azimuth_deg=0.0,
                       amplitude=1000.0)]
    ideal = synthesize_cube(tgt, 2, cfg, noise_std=0.0,
                            clutter_amplitude=0.0, seed=0)[1]
    ks = golden.keystone_transform(cube[None], cfg)[0]
    p_sm, p_ks, p_id = (_rd_power(c, cfg) for c in (cube, ks, ideal))
    assert p_sm.max() < 0.45 * p_id.max()           # migration smears
    assert abs(p_ks.max() / p_id.max() - 1.0) < 1e-3  # keystone refocuses
    assert np.unravel_index(p_ks.argmax(), p_ks.shape) == np.unravel_index(
        p_id.argmax(), p_id.shape)


def test_keystone_identity_at_zero_velocity():
    """A static target has no coupling (the slow-time signal sits at
    k=0, which every alpha_n scaling maps to itself): keystone is the
    identity on it to numerical precision."""
    cfg = WALK_CFG
    cube = _walk_cube(v=0.0)
    ks = golden.keystone_transform(cube[None], cfg)[0]
    err = np.abs(ks - cube).max() / np.abs(cube).max()
    assert err < 1e-9


def test_op_matches_golden():
    """jnp keystone_cube vs the f64 golden twin (c64-level tolerance)."""
    cfg = RadarConfig(num_chirps=64)  # small: CPU-friendly
    rng = np.random.default_rng(3)
    cube = (rng.standard_normal((2, cfg.num_rx, 64, cfg.num_samples))
            + 1j * rng.standard_normal((2, cfg.num_rx, 64, cfg.num_samples)))
    want = golden.keystone_transform(cube, cfg)
    got = np.asarray(keystone_cube(jnp.asarray(cube, jnp.complex64), cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


def test_op_matches_golden_tdm():
    """TDM per-stream fractional offsets agree between op and golden."""
    cfg = RadarConfig(num_chirps=64, num_tx=2)
    rng = np.random.default_rng(4)
    shape = (1, cfg.num_virtual_rx, 32, cfg.num_samples)
    cube = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    want = golden.keystone_transform(cube, cfg)
    got = np.asarray(keystone_cube(jnp.asarray(cube, jnp.complex64), cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


def test_unvirtualized_cube_rejected():
    cfg = RadarConfig(num_chirps=64, num_tx=2)
    bad = jnp.zeros((1, cfg.num_rx, cfg.num_chirps, cfg.num_samples),
                    jnp.complex64)
    with pytest.raises(ValueError, match="virtualized"):
        keystone_cube(bad, cfg)
    with pytest.raises(ValueError, match="virtualized"):
        golden.keystone_transform(np.zeros(bad.shape), cfg)


def test_pipeline_keystone_end_to_end():
    """RDPipeline(keystone=True): the walking target lost by the plain
    pipeline (smeared below threshold / wrong cell) is detected at the
    right range and velocity with keystone on."""
    from mmradar.models.rd_pipeline import RDPipeline

    cfg = WALK_CFG
    cube = _walk_cube()
    shorts = encode_frame(np.stack([np.zeros_like(cube), cube]), cfg)
    plain = RDPipeline(cfg, max_detections=4)
    pipe = RDPipeline(cfg, max_detections=4, keystone=True)
    assert pipe._resolve_rd_impl() in ("fft", "mxu")
    base = pipe.prepare_base(shorts[0])
    out = pipe.detect(shorts[1:], base)
    assert bool(out.valid[0, 0])
    assert abs(float(out.range_m[0, 0]) - 5.0) < 0.3
    assert abs(float(out.velocity_mps[0, 0]) - 10.0) < 0.2
    # the plain pipeline's strongest cell is materially weaker (the
    # slow-time Hann window tapers the CPI edges, so the pipeline-level
    # smearing loss is milder than the unwindowed f64 check above:
    # measured ratio 0.73)
    out_plain = plain.detect(shorts[1:], base)
    assert float(out_plain.power[0, 0]) < 0.85 * float(out.power[0, 0])


def test_pipeline_keystone_rejects_planar_impls():
    from mmradar.models.rd_pipeline import RDPipeline

    for impl in ("planar", "fused"):
        with pytest.raises(ValueError, match="keystone"):
            RDPipeline(WALK_CFG, keystone=True,
                       rd_impl=impl)._resolve_rd_impl()


def test_default_generator_unchanged_by_flag_default():
    """chirp_level_motion=False is byte-identical to the historical
    generator (no existing capture or test data shifts)."""
    cfg = RadarConfig()
    tgt = [SceneTarget(range_m=5.0, velocity_mps=3.0, azimuth_deg=10.0,
                       amplitude=900.0)]
    a = synthesize_cube(tgt, 3, cfg, seed=11)
    b = synthesize_cube(tgt, 3, cfg, seed=11, chirp_level_motion=False)
    np.testing.assert_array_equal(a, b)
