"""Parity tests for the plain range-Doppler front-ends.

Every ``rd_impl`` ('fft' — the auto default —, 'mxu', 'planar',
'fused') must give the same detections on the same frames, across clutter
modes, CFAR kinds, TDM-MIMO, precisions and geometries whose range size
is not a power of two, and ``detect`` must be exactly ``maps`` plus the
detection tail.  The front-ends themselves are golden-verified in
test_pipeline.py and test_xla_stages.py.

Reference contract being upgraded: the single argmax detector at
acceleration.cu:522 with every intermediate materialized
(acceleration.cu:435-519).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import (
    RDPipeline,
    assemble_result,
    gather_snapshots,
)


def _assert_same_detections(a, b, max_flips=0):
    """Slot-exact detection comparison.

    ``max_flips > 0`` tolerates that many detection-SET differences
    across the whole batch: cross-implementation pairs (FFT library vs
    DFT matmuls) round in different orders, so a cell sitting next to
    its CFAR threshold can flip while the power maps agree to ~1e-6 of
    the global max.  Frames with zero flips are still compared
    slot-exactly."""
    av = np.asarray(a.valid).astype(bool)
    bv = np.asarray(b.valid).astype(bool)
    a_db, b_db = np.asarray(a.doppler_bin), np.asarray(b.doppler_bin)
    a_rb, b_rb = np.asarray(a.range_bin), np.asarray(b.range_bin)
    a_nh = np.asarray(a.num_hits)
    b_nh = np.asarray(b.num_hits)
    flips, clean = 0, []
    for f in range(av.shape[0]):
        sa = {(int(d), int(r))
              for d, r in zip(a_db[f][av[f]], a_rb[f][av[f]])}
        sb = {(int(d), int(r))
              for d, r in zip(b_db[f][bv[f]], b_rb[f][bv[f]])}
        # num_hits counts ALL CFAR hits, so a marginal cell that never
        # reaches the top-K slots still shows up here — count it as a
        # flip too
        n = len(sa ^ sb) + abs(int(a_nh[f]) - int(b_nh[f]))
        flips += n
        if n == 0:
            clean.append(f)
    assert flips <= max_flips, (
        f"{flips} detection-set flips across the batch "
        f"(allowed {max_flips})"
    )
    cl = np.asarray(clean, int)
    for fname in ("range_bin", "doppler_bin", "valid", "angle_bin",
                  "num_hits"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, fname))[cl],
            np.asarray(getattr(b, fname))[cl], err_msg=fname,
        )


def _pair(cfg, impl_a, impl_b, k=8, **kw):
    return (RDPipeline(cfg, max_detections=k, rd_impl=impl_a, **kw),
            RDPipeline(cfg, max_detections=k, rd_impl=impl_b, **kw))


@pytest.mark.parametrize("use_base", [True, False])
def test_fused_matches_fft(cfg, targets, use_base):
    """The fused matmul front-end vs the complex-cube FFT path."""
    shorts = synthesize_capture(targets, 4, cfg, noise_std=2.0, seed=51)
    fft, fused = _pair(cfg, "fft", "fused", use_base_frame=use_base)
    base = fft.prepare_base(jnp.asarray(shorts[0])) if use_base else None
    a = fft.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    _assert_same_detections(a, b, max_flips=2)
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(a.azimuth_deg),
                               np.asarray(b.azimuth_deg),
                               rtol=1e-4, atol=1e-3)


def test_ca_cfar_threshold_on_pipeline_maps(cfg, targets):
    """CA-CFAR on the pipeline's own power maps == the float64 golden
    CFAR on those maps, and the maps' hits are that decision."""
    from mmradar.ops.cfar import ca_cfar_2d

    shorts = synthesize_capture(targets, 4, cfg, noise_std=2.0, seed=52)
    pipe = RDPipeline(cfg, max_detections=8)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    power, hits = pipe.maps(jnp.asarray(shorts[1:]), base)
    _, thresh = ca_cfar_2d(power, cfg)
    p64 = np.asarray(power, np.float64)
    _, want = golden.ca_cfar_2d(p64, cfg.cfar_guard, cfg.cfar_train,
                                cfg.cfar_pfa, cfg.cfar_range_mode,
                                n_pulses=cfg.cfar_pulses_effective)
    # f32 window sums over ~1e11-peak cells: the (total - inner)
    # cancellation leaves ~1e-3 relative near strong targets
    np.testing.assert_allclose(np.asarray(thresh), want, rtol=1e-3)
    np.testing.assert_array_equal(np.asarray(hits),
                                  np.asarray(power > thresh))


def test_ca_cfar_range_wrap(targets):
    """cfar_range_mode='wrap' on the pipeline's maps matches golden."""
    from mmradar.ops.cfar import ca_cfar_2d

    cfg2 = RadarConfig(cfar_range_mode="wrap")
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=53)
    pipe = RDPipeline(cfg2, max_detections=8, rd_impl="fused")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    power, _ = pipe.maps(jnp.asarray(shorts[1:]), base)
    _, thresh = ca_cfar_2d(power, cfg2)
    _, want = golden.ca_cfar_2d(np.asarray(power, np.float64),
                                cfg2.cfar_guard, cfg2.cfar_train,
                                cfg2.cfar_pfa, "wrap",
                                n_pulses=cfg2.cfar_pulses_effective)
    np.testing.assert_allclose(np.asarray(thresh), want, rtol=1e-3)


def test_fused_mimo_matches_fft(targets):
    """TDM-MIMO (num_tx=2): the fused in-contraction demux matches the
    FFT path's explicit virtualize_cube."""
    cfg2 = RadarConfig(num_tx=2)
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=54)
    fft, fused = _pair(cfg2, "fft", "fused")
    base = fft.prepare_base(jnp.asarray(shorts[0]))
    a = fft.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    _assert_same_detections(a, b, max_flips=2)
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4, atol=1e-2)


def test_fused_os_cfar_matches_fft(cfg, targets):
    """cfar_kind='os' (decimated ring) on the fused maps vs fft."""
    cfg_os = RadarConfig(cfar_kind="os", cfar_os_stride=8)
    shorts = synthesize_capture(targets, 3, cfg_os, noise_std=2.0, seed=55)
    fft, fused = _pair(cfg_os, "fft", "fused")
    base = fft.prepare_base(jnp.asarray(shorts[0]))
    a = fft.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    _assert_same_detections(a, b, max_flips=2)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_matmul_precision_variants(cfg, targets, precision):
    """The matmul front-ends honor cfg.dft_precision; the strong target
    survives at every precision and 'highest' matches the FFT path."""
    cfg_p = RadarConfig(dft_precision=precision)
    shorts = synthesize_capture(targets, 3, cfg_p, noise_std=2.0, seed=56)
    fft, fused = _pair(cfg_p, "fft", "fused")
    base = fused.prepare_base(jnp.asarray(shorts[0]))
    out = fused.detect(jnp.asarray(shorts[1:]), base)
    assert int(np.asarray(out.num_hits).min()) > 0
    if precision == "highest":
        _assert_same_detections(fft.detect(jnp.asarray(shorts[1:]), base),
                                out)


def test_mxu_unbatched(cfg, targets):
    """A single unbatched frame keeps its scalar leading shape."""
    shorts = synthesize_capture(targets, 2, cfg, noise_std=2.0, seed=57)
    pipe = RDPipeline(cfg, max_detections=8, rd_impl="mxu")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1]), base)
    assert out.range_bin.shape == (8,)
    assert int(np.asarray(out.num_hits)) > 0


@pytest.mark.parametrize("use_base", [True, False])
def test_plane_snapshots_match_cube_gather(cfg, targets, use_base):
    """AoA snapshots gathered from the fused re/im planes == gathered
    from the FFT path's complex RD cube (base and mean clutter)."""
    from mmradar.ops.fuseddft import fused_rd_planes

    shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=58)
    pipe = RDPipeline(cfg, max_detections=8, rd_impl="fft",
                      use_base_frame=use_base)
    base = pipe.prepare_base(jnp.asarray(shorts[0])) if use_base else None
    x = jnp.asarray(shorts[1:])
    dr, di = fused_rd_planes(x, base, cfg)
    power = jnp.sum(dr * dr + di * di, axis=-3)
    top_idx = jax.lax.top_k(power.reshape(power.shape[0], -1), 8)[1]
    got = jax.lax.complex(gather_snapshots(dr, top_idx),
                          gather_snapshots(di, top_idx))
    want = gather_snapshots(pipe.rd_cube(x, base), top_idx)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-2 * float(jnp.abs(want).max()))


_EXACT_FIELDS = (
    "num_hits", "doppler_bin", "range_bin", "valid", "power", "range_m",
    "velocity_mps", "range_m_interp", "velocity_mps_interp", "angle_bin",
    "azimuth_deg",
)


def _assert_detect_is_maps_plus_tail(pipe, shorts, base):
    """detect() == assemble_result over maps(): the tail adds nothing
    the maps do not determine."""
    a = pipe.detect(shorts, base)

    @jax.jit
    def twin(x, bc):
        power, hits, snaps = pipe._maps(x, bc, pipe._resolve_rd_impl())
        return assemble_result(power, snaps, hits, pipe.max_detections,
                               pipe.cfg)

    b = twin(shorts, base)
    for f in _EXACT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
            err_msg=f,
        )


@pytest.mark.parametrize("use_base", [True, False])
def test_detect_is_maps_plus_tail(cfg, targets, use_base):
    shorts = synthesize_capture(targets, 4, cfg, noise_std=2.0, seed=91)
    pipe = RDPipeline(cfg, max_detections=8, rd_impl="fused",
                      use_base_frame=use_base)
    base = pipe.prepare_base(jnp.asarray(shorts[0])) if use_base else None
    _assert_detect_is_maps_plus_tail(pipe, jnp.asarray(shorts[1:]), base)


def test_detect_is_maps_plus_tail_mimo(targets):
    """Same contract under TDM-MIMO (demux + per-detection Doppler
    compensation in the tail)."""
    cfg2 = RadarConfig(num_tx=2)
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=92)
    pipe = RDPipeline(cfg2, max_detections=8, rd_impl="planar")
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    _assert_detect_is_maps_plus_tail(pipe, jnp.asarray(shorts[1:]), base)


@pytest.mark.parametrize("kind", ["goca", "soca"])
def test_go_so_cfar_front_ends_agree(kind, targets):
    """GOCA/SOCA: detect is maps + tail on the fused front-end, and its
    detections match the FFT path; the kinds genuinely detect."""
    cfg2 = RadarConfig(cfar_kind=kind)
    shorts = synthesize_capture(targets, 4, cfg2, noise_std=2.0, seed=71)
    fft, fused = _pair(cfg2, "fft", "fused")
    base = fft.prepare_base(jnp.asarray(shorts[0]))
    x = jnp.asarray(shorts[1:])
    _assert_detect_is_maps_plus_tail(fused, x, base)
    a = fused.detect(x, base)
    _assert_same_detections(a, fft.detect(x, base), max_flips=2)
    assert bool(np.asarray(a.num_hits).max() >= 1)


def test_detect_exhausted_slots_match_topk(cfg):
    """With nearly-empty hit maps, exhausted slots must carry the same
    ascending untaken indices as lax.top_k, on every front-end."""
    shorts = synthesize_capture(
        [SceneTarget(5.0, 0.0, 0.0)], 3, cfg, noise_std=0.5, seed=93
    )
    fused, fft = _pair(cfg, "fused", "fft", k=32)
    base = fused.prepare_base(jnp.asarray(shorts[0]))
    a = fused.detect(jnp.asarray(shorts[1:]), base)
    b = fft.detect(jnp.asarray(shorts[1:]), base)
    assert not bool(np.asarray(a.valid).all())  # exhausted slots exist
    np.testing.assert_array_equal(np.asarray(a.range_bin),
                                  np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.doppler_bin),
                                  np.asarray(b.doppler_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))


def test_detect_k_above_128(cfg, targets):
    """max_detections above 128 works, and its first slots are exactly
    the small-K result (top-K is a prefix of top-K')."""
    shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=60)
    big = RDPipeline(cfg, max_detections=200, rd_impl="fused")
    small = RDPipeline(cfg, max_detections=8, rd_impl="fused")
    base = big.prepare_base(jnp.asarray(shorts[0]))
    a = big.detect(jnp.asarray(shorts[1:]), base)
    b = small.detect(jnp.asarray(shorts[1:]), base)
    assert a.range_bin.shape[-1] == 200
    for f in _EXACT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f))[..., :8] if f != "num_hits"
            else np.asarray(a.num_hits),
            np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("geom", [
    dict(num_samples=64, num_chirps=64, num_rx=2),   # R=64
    dict(num_samples=48, num_chirps=128),            # R=64, full chirps
])
def test_small_range_geometry_fused_matches_fft(geom, targets):
    """Geometries with a 64-bin range axis: fused == fft on
    detections."""
    cfg2 = RadarConfig(**geom)
    assert cfg2.range_fft_size % 128 != 0
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=95)
    fft, fused = _pair(cfg2, "fft", "fused")
    base = fft.prepare_base(jnp.asarray(shorts[0]))
    a = fft.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    _assert_same_detections(a, b, max_flips=2)
    np.testing.assert_allclose(np.asarray(a.power), np.asarray(b.power),
                               rtol=2e-4, atol=1e-2)


def test_small_range_geometry_planar_matches_mxu(targets):
    """The split-plane path at a 64-bin geometry: identical real
    arithmetic to the complex-cube matmul path on valid slots."""
    cfg2 = RadarConfig(num_samples=64, num_chirps=64, num_rx=2)
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=96)
    mxu, planar = _pair(cfg2, "mxu", "planar")
    base = mxu.prepare_base(jnp.asarray(shorts[0]))
    a = planar.detect(jnp.asarray(shorts[1:]), base)
    b = mxu.detect(jnp.asarray(shorts[1:]), base)
    valid = np.asarray(b.valid)
    np.testing.assert_array_equal(np.asarray(a.valid), valid)
    np.testing.assert_array_equal(np.asarray(a.num_hits),
                                  np.asarray(b.num_hits))
    for f in ("doppler_bin", "range_bin"):
        ga, gb = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_array_equal(ga[valid], gb[valid], err_msg=f)
    np.testing.assert_allclose(np.asarray(a.power)[valid],
                               np.asarray(b.power)[valid], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a.azimuth_deg)[valid],
                               np.asarray(b.azimuth_deg)[valid], atol=1e-3)


def test_go_so_small_range_geometry(targets):
    """GOCA at a 64-bin range geometry: fused matches fft."""
    cfg2 = RadarConfig(num_samples=64, num_chirps=64, num_rx=2,
                       cfar_kind="goca")
    assert cfg2.range_fft_size % 128 != 0
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=97)
    fft, fused = _pair(cfg2, "fft", "fused")
    base = fft.prepare_base(jnp.asarray(shorts[0]))
    a = fft.detect(jnp.asarray(shorts[1:]), base)
    b = fused.detect(jnp.asarray(shorts[1:]), base)
    _assert_same_detections(a, b, max_flips=2)
