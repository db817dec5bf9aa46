"""Clutter-map (Nitzberg) CFAR: alpha statistics, golden/jnp parity,
the varying-floor case spatial CA gets wrong, end-to-end + serve."""

import numpy as np
import jax.numpy as jnp
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import RDPipeline
from mmradar.ops.cmap import clutter_map_cfar


def test_alpha_realizes_design_pfa_monte_carlo():
    """The exponential-MGF product formula is exact for the block form:
    realized Pfa on iid exponential maps lands on the configured rate
    (measured 1.03e-3 vs 1e-3)."""
    rng = np.random.default_rng(0)
    beta, pfa, block = 0.25, 1e-3, 16
    p = rng.exponential(1.0, (640, 48, 48))
    hits, _ = golden.clutter_map_cfar(p, pfa, beta, block=block)
    meas = hits[8 * block:].mean()   # past warmup
    assert 0.6 * pfa < meas < 1.6 * pfa, meas
    # per-frame (block=1) classic Nitzberg form too
    a1 = golden.clutter_map_alpha(pfa, beta, 1)
    m = p[0].copy()
    h = n = 0
    for f in range(1, 240):
        if f > 40:
            h += (p[f] > a1 * m).sum()
            n += p[f].size
        m = (1 - beta) * m + beta * p[f]
    assert 0.6 * pfa < h / n < 1.6 * pfa, h / n


def test_jnp_matches_golden():
    # 22 frames at block=8: seed block + 1 full block + a 6-frame tail
    rng = np.random.default_rng(1)
    p = rng.exponential(1.0, (22, 32, 48)).astype(np.float32)
    p[10, 10, 20] = 500.0
    want_h, want_m = golden.clutter_map_cfar(p, 1e-3, 0.25, block=8)
    got_h, got_m = clutter_map_cfar(jnp.asarray(p), 1e-3, 0.25, block=8)
    np.testing.assert_array_equal(np.asarray(got_h), want_h)
    np.testing.assert_allclose(np.asarray(got_m), want_m, rtol=1e-5)
    # seeded form: one batch-as-block continuation from an explicit map
    m0 = p[:8].mean(axis=0)
    h2, m2 = clutter_map_cfar(jnp.asarray(p[8:]), 1e-3, 0.25,
                              m0=jnp.asarray(m0), seeded=True, block=8)
    assert np.asarray(h2).shape == (14, 32, 48)
    a = golden.clutter_map_alpha(1e-3, 0.25, 8)
    np.testing.assert_array_equal(np.asarray(h2), p[8:] > a * m0)


def test_varying_floor_beats_spatial_ca():
    """A clutter-floor step across range: spatial CA false-alarms on the
    low side of the edge (the ring mixes both levels) and needs a
    target on the high side to clear an inflated threshold; the clutter
    map adapts per cell and gets both right."""
    from mmradar.ops.cfar import cfar_detect

    rng = np.random.default_rng(2)
    d_sz, r_sz, n_f = 64, 128, 200
    scale = np.ones(r_sz)
    scale[r_sz // 2:] = 30.0          # 15 dB floor step at mid-range
    p = rng.exponential(1.0, (n_f, d_sz, r_sz)) * scale
    # a target APPEARS at frame 150 near the step's high side, 13 dB
    # above its local floor
    tgt_d, tgt_r = 20, r_sz // 2 + 3
    p[150:, tgt_d, tgt_r] += 20.0 * 30.0
    cfg = RadarConfig()

    hits_ca, _ = cfar_detect(jnp.asarray(p, jnp.float32), cfg, "xla")
    hits_cm, _ = clutter_map_cfar(jnp.asarray(p, jnp.float32),
                                  cfg.cfar_pfa, 0.25, block=16)
    hits_ca = np.asarray(hits_ca)
    hits_cm = np.asarray(hits_cm)
    steady = slice(120, n_f)          # past the map's convergence
                                      # (~4 blocks at beta=0.25)
    # false alarms over the whole map excluding the target cell: the
    # spatial ring straddling the step mixes the two levels, so cells
    # near the edge see a mis-biased threshold and leak; the per-cell
    # map realizes ~the configured rate (measured 1.4e-4 vs 1e-4 here,
    # ~2x fewer false alarms than CA on this scene)
    mask = np.ones((d_sz, r_sz), bool)
    mask[tgt_d, tgt_r] = False
    fa_ca = int(hits_ca[steady][:, mask].sum())
    fa_cm = int(hits_cm[steady][:, mask].sum())
    cells = hits_ca[steady][:, mask].size
    # measured: cmap 7.9e-5 (on design) vs CA 2.3e-4 on this scene
    assert fa_cm / cells < 1.5 * cfg.cfar_pfa, fa_cm / cells
    assert fa_ca > 2.0 * fa_cm, (fa_ca, fa_cm)
    # semantics split: the clutter map detects the arrival (the whole
    # block until the next update: frames 150-159 measured) then
    # absorbs the now-steady target into its background (a change
    # detector — movers are its use case, see the end-to-end test);
    # spatial CA holds the steady target throughout (its strength)
    assert hits_cm[150:158, tgt_d, tgt_r].all()
    assert hits_cm[176:, tgt_d, tgt_r].mean() < 0.5
    assert hits_ca[160:, tgt_d, tgt_r].mean() > 0.8


def test_moving_target_stays_detected(cfg):
    """A mover keeps leaving its cells faster than the block-updated map
    absorbs them: past the seed block, Pd stays 1 end-to-end (10 m/s =
    ~0.21 range bins/frame, so every 16-frame map update the target is
    ~3 cells ahead of its own history)."""
    tgt = SceneTarget(range_m=3.0, velocity_mps=10.0, azimuth_deg=10.0,
                      amplitude=2000.0)
    cap = synthesize_capture([tgt], 41, cfg, noise_std=10.0, seed=3)
    pipe = RDPipeline(cfg, max_detections=16)
    base = pipe.prepare_base(cap[0])
    rd, m_out = pipe.detect_cmap(jnp.asarray(cap[1:]), base)
    rng_m = np.asarray(rd.range_m)
    valid = np.asarray(rd.valid)
    dt = cfg.num_chirps * cfg.chirp_interval_s
    for f in range(17, valid.shape[0]):  # frames 0-15 are the seed block
        want = 3.0 + 10.0 * (f + 2) * dt
        assert any(valid[f, k] and abs(rng_m[f, k] - want) < 0.8
                   for k in range(valid.shape[1])), f
    assert m_out.shape == (cfg.doppler_fft_size, cfg.range_fft_size)
    # stateful continuation: seeding a second call with m_out detects
    # from its FIRST frame
    rd2, _ = pipe.detect_cmap(jnp.asarray(cap[-1:]), base, m0=m_out)
    assert bool(np.asarray(rd2.valid)[0].any())


def test_cli_detect_cmap(tmp_path, cfg):
    import json

    from mmradar import cli
    from mmradar.io.capture import write_capture

    tgt = SceneTarget(range_m=5.0, velocity_mps=8.0, azimuth_deg=-5.0,
                      amplitude=2000.0)
    cap = synthesize_capture([tgt], 21, cfg, noise_std=10.0, seed=4)
    path = tmp_path / "c.bin"
    write_capture(str(path), np.asarray(cap))
    out = tmp_path / "d.jsonl"
    rc = cli.main(["detect", str(path), "--out", str(out), "--full",
                   "--cmap"])
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(recs) == 20
    # first 16 records are the seed block (warmup), the rest detect
    assert not any(r["detections"] for r in recs[:16])
    assert all(r["detections"] for r in recs[16:])
    # guards
    assert cli.main(["detect", str(path), "--cmap"]) == 2
    assert cli.main(["detect", str(path), "--full", "--cmap",
                     "--integrate", "2"]) == 2


def test_serve_cmap_carries_state(cfg, serve_over_udp):
    """A target APPEARING mid-stream is detected on arrival against the
    carried noise-only background (a clutter map is a change detector —
    a target already inside the seed stays absorbed, by design)."""
    tgt = SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=15.0,
                      amplitude=3000.0)
    empty = synthesize_capture([], 4, cfg, noise_std=5.0, seed=5)
    with_t = synthesize_capture([tgt], 7, cfg, noise_std=5.0, seed=6)
    cap = np.concatenate([np.asarray(empty), np.asarray(with_t[4:])])
    # --serve-batch 1 pins one frame per dispatch: dispatch 1 seeds the
    # map from an EMPTY frame, later dispatches carry the state
    recs = serve_over_udp(cap, ["--cmap", "--serve-batch", "1"])
    frame_recs = [r for r in recs if "frame" in r]
    assert len(frame_recs) == 6
    assert not frame_recs[0]["detections"]     # seed dispatch
    # the empty-scene frames stay quiet near the target range...
    for r in frame_recs[1:3]:
        assert not any(abs(d["range_m"] - 5.0) < 1.0
                       for d in r["detections"])
    # ...and the arrival is detected
    arrival = [d for r in frame_recs[3:] for d in r["detections"]]
    assert any(abs(d["range_m"] - 5.0) < 1.0 for d in arrival)
