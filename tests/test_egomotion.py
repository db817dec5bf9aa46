"""Ego-motion estimation: golden/jnp parity, robustness, end-to-end."""

import json

import numpy as np
import jax.numpy as jnp
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import (
    SceneTarget,
    static_scene_targets,
    synthesize_capture,
)
from mmradar.models.rd_pipeline import RDPipeline
from mmradar.ops.egomotion import (
    ego_compensated_velocity,
    estimate_ego_motion,
)

V_EGO = (1.5, 8.0)  # (vx lateral, vy forward), well inside the ~15 m/s span


def _scene(rng, n_static=12, movers=()):
    """(az_deg, vr, valid) for n_static static points + given movers."""
    az = rng.uniform(-60, 60, n_static)
    vr = -(V_EGO[0] * np.sin(np.deg2rad(az))
           + V_EGO[1] * np.cos(np.deg2rad(az)))
    vr += rng.uniform(-0.05, 0.05, n_static)  # measurement noise
    for m_az, m_vr in movers:
        az = np.append(az, m_az)
        vr = np.append(vr, m_vr)
    return az, vr, np.ones(az.shape, bool)


def test_golden_recovers_ego_velocity():
    az, vr, valid = _scene(np.random.default_rng(0))
    v, static, ok = golden.estimate_ego_motion(az, vr, valid)
    assert ok
    np.testing.assert_allclose(v, V_EGO, atol=0.1)
    assert static.all()


def test_golden_rejects_movers():
    # two movers far off the static sinusoid
    az, vr, valid = _scene(np.random.default_rng(1),
                           movers=[(10.0, 4.0), (-25.0, -3.0)])
    v, static, ok = golden.estimate_ego_motion(az, vr, valid)
    assert ok
    np.testing.assert_allclose(v, V_EGO, atol=0.1)
    assert not static[-1] and not static[-2]
    assert static[:-2].all()


def test_golden_degenerate_cases():
    # fewer than 3 detections
    v, static, ok = golden.estimate_ego_motion(
        np.array([0.0, 10.0]), np.array([-8.0, -7.9]))
    assert not ok and not static.any() and np.all(v == 0)
    # all detections at ONE azimuth: rank-1 normal matrix
    az = np.zeros(8)
    vr = np.full(8, -8.0)
    v, static, ok = golden.estimate_ego_motion(az, vr)
    assert not ok and not static.any() and np.all(v == 0)


def test_jnp_matches_golden_batched():
    rng = np.random.default_rng(2)
    k_max = 16
    az_b = np.zeros((3, k_max))
    vr_b = np.zeros((3, k_max))
    valid_b = np.zeros((3, k_max), bool)
    for i, movers in enumerate(([], [(5.0, 6.0)], [(0.0, 3.0), (30.0, -5.0)])):
        az, vr, valid = _scene(rng, movers=movers)
        az_b[i, : len(az)] = az
        vr_b[i, : len(vr)] = vr
        valid_b[i, : len(valid)] = valid
    out = estimate_ego_motion(jnp.asarray(az_b), jnp.asarray(vr_b),
                              jnp.asarray(valid_b))
    for i in range(3):
        v_g, static_g, ok_g = golden.estimate_ego_motion(
            az_b[i], vr_b[i], valid_b[i])
        assert bool(out.ok[i]) == ok_g
        np.testing.assert_allclose(np.asarray(out.velocity[i]), v_g,
                                   atol=1e-4)
        np.testing.assert_array_equal(np.asarray(out.is_static[i]),
                                      static_g)
        assert int(out.n_inliers[i]) == int(static_g.sum())


def test_jnp_degenerate_frame_in_batch():
    # frame 0 good, frame 1 has only 2 valid detections
    az, vr, valid = _scene(np.random.default_rng(3))
    valid2 = np.zeros_like(valid)
    valid2[:2] = True
    out = estimate_ego_motion(
        jnp.asarray(np.stack([az, az])), jnp.asarray(np.stack([vr, vr])),
        jnp.asarray(np.stack([valid, valid2])))
    assert bool(out.ok[0]) and not bool(out.ok[1])
    assert np.all(np.asarray(out.velocity[1]) == 0)
    assert not np.asarray(out.is_static[1]).any()


def test_compensated_velocity_zeroes_static():
    az, vr, valid = _scene(np.random.default_rng(4),
                           movers=[(12.0, 5.0)])
    out = estimate_ego_motion(jnp.asarray(az[None]), jnp.asarray(vr[None]),
                              jnp.asarray(valid[None]))
    vg = ego_compensated_velocity(jnp.asarray(az[None]),
                                  jnp.asarray(vr[None]), out.velocity)
    vg = np.asarray(vg)[0]
    # static scatterers land near zero ground velocity; the mover's
    # ground-frame radial velocity is its sensor-frame 5.0 plus the ego
    # projection at az 12 deg
    expect = 5.0 + (V_EGO[0] * np.sin(np.deg2rad(12.0))
                    + V_EGO[1] * np.cos(np.deg2rad(12.0)))
    assert np.abs(vg[:-1]).max() < 0.2
    assert abs(vg[-1] - expect) < 0.2
    # golden twin agrees
    vg_g = golden.ego_compensated_velocity(
        az, vr, np.asarray(out.velocity[0]))
    np.testing.assert_allclose(vg, vg_g, atol=1e-4)


def test_end_to_end_capture(cfg):
    """Synthesize a moving-platform scene, detect, fit ego motion."""
    tgts = static_scene_targets(
        V_EGO,
        ranges_m=[3.0, 5.0, 7.0, 9.0, 4.0, 6.5],
        azimuths_deg=[-40.0, -20.0, 0.0, 15.0, 35.0, 50.0],
        amplitude=2500.0,
    )
    # one genuine mover, well off the static sinusoid
    tgts.append(SceneTarget(range_m=8.0, velocity_mps=5.0,
                            azimuth_deg=-10.0, amplitude=2500.0))
    cap = synthesize_capture(tgts, 4, cfg, noise_std=5.0, seed=7)
    pipe = RDPipeline(cfg, max_detections=16)
    base = pipe.prepare_base(cap[0])
    rd = pipe.detect(jnp.asarray(cap[1:]), base)
    out = estimate_ego_motion(rd.azimuth_deg, rd.velocity_mps, rd.valid)
    ok = np.asarray(out.ok)
    assert ok.all()
    v = np.asarray(out.velocity)
    # Doppler-bin quantization (~0.24 m/s) + angle-bin quantization bound
    # the fit error
    np.testing.assert_allclose(v, np.tile(V_EGO, (3, 1)), atol=0.35)
    # the mover is flagged non-static in every frame it is detected
    az = np.asarray(rd.azimuth_deg)
    vr = np.asarray(rd.velocity_mps)
    valid = np.asarray(rd.valid)
    static = np.asarray(out.is_static)
    for f in range(valid.shape[0]):
        for k in range(valid.shape[1]):
            if valid[f, k] and abs(az[f, k] - (-10.0)) < 4.0 and vr[f, k] > 3.0:
                assert not static[f, k]


def test_cli_detect_ego(tmp_path, cfg):
    from mmradar import cli
    from mmradar.io.capture import write_capture

    tgts = static_scene_targets(
        V_EGO, ranges_m=[3.0, 6.0, 9.0, 5.0],
        azimuths_deg=[-30.0, -10.0, 10.0, 40.0], amplitude=2500.0)
    cap = synthesize_capture(tgts, 3, cfg, noise_std=5.0, seed=9)
    path = tmp_path / "ego.bin"
    write_capture(str(path), np.asarray(cap))
    out = tmp_path / "ego.jsonl"
    rc = cli.main(["detect", str(path), "--out", str(out), "--full", "--ego"])
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    assert all("ego" in r for r in recs)
    ok_recs = [r for r in recs if r["ego"]["ok"]]
    assert ok_recs
    for r in ok_recs:
        assert abs(r["ego"]["vx_mps"] - V_EGO[0]) < 0.4
        assert abs(r["ego"]["vy_mps"] - V_EGO[1]) < 0.4
        assert r["ego"]["n_static"] >= 3
        for d in r["detections"]:
            assert "is_static" in d and "velocity_ground_mps" in d
            if d["is_static"]:
                assert abs(d["velocity_ground_mps"]) < 0.5


def test_cli_detect_ego_requires_full(tmp_path, cfg):
    from mmradar import cli
    from mmradar.io.capture import write_capture

    cap = synthesize_capture([SceneTarget(range_m=3.0)], 2, cfg, seed=0)
    path = tmp_path / "c.bin"
    write_capture(str(path), np.asarray(cap))
    assert cli.main(["detect", str(path), "--ego"]) == 2


def test_cli_track_ego_drops_static_world(tmp_path, cfg, capsys):
    """Moving-platform tracking: without --ego the static world confirms
    tracks; with it only the genuine mover tracks."""
    from mmradar import cli
    from mmradar.io.capture import write_capture

    tgts = static_scene_targets(
        V_EGO, ranges_m=[3.0, 5.5, 8.0, 4.5],
        azimuths_deg=[-35.0, -15.0, 20.0, 45.0], amplitude=2500.0)
    tgts.append(SceneTarget(range_m=7.0, velocity_mps=4.0,
                            azimuth_deg=0.0, amplitude=2500.0))
    cap = synthesize_capture(tgts, 8, cfg, noise_std=5.0, seed=11)
    path = tmp_path / "drive.bin"
    write_capture(str(path), np.asarray(cap))

    rc = cli.main(["track", str(path)])
    assert rc in (0, None)
    base_tracks = [json.loads(l) for l in
                   capsys.readouterr().out.splitlines() if l.strip()]
    rc = cli.main(["track", str(path), "--ego"])
    assert rc in (0, None)
    ego_tracks = [json.loads(l) for l in
                  capsys.readouterr().out.splitlines() if l.strip()]
    assert len(base_tracks) >= 4  # static world confirms tracks
    assert len(ego_tracks) == 1   # only the mover survives the ego gate
    t = ego_tracks[0]
    assert abs(t["range_m"] - 7.0) < 1.0
    # ground-frame radial velocity = sensor 4.0 + ego projection at az 0
    assert abs(t["velocity_ground_mps"] - (4.0 + V_EGO[1])) < 0.5



def test_serve_ego_labels_and_tracks_movers(cfg, serve_over_udp):
    """serve --ego: detections get static/moving labels + ground-frame
    velocities and the tracker sees movers only."""
    tgts = static_scene_targets(
        V_EGO, ranges_m=[3.0, 5.5, 8.0, 4.5],
        azimuths_deg=[-35.0, -15.0, 20.0, 45.0], amplitude=2500.0)
    tgts.append(SceneTarget(range_m=7.0, velocity_mps=4.0,
                            azimuth_deg=0.0, amplitude=2500.0))
    cap = synthesize_capture(tgts, 6, cfg, noise_std=5.0, seed=13)
    recs = serve_over_udp(np.asarray(cap), ["--ego"])
    frame_recs = [r for r in recs if "frame" in r]
    assert frame_recs
    ok_recs = [r for r in frame_recs if r.get("ego", {}).get("ok")]
    assert ok_recs
    for r in ok_recs:
        assert abs(r["ego"]["vx_mps"] - V_EGO[0]) < 0.4
        assert abs(r["ego"]["vy_mps"] - V_EGO[1]) < 0.4
        for d in r["detections"]:
            assert "is_static" in d and "velocity_ground_mps" in d
    # confirmed tracks are movers only (static world excluded)
    last_tracks = frame_recs[-1]["tracks"]
    assert last_tracks
    for t in last_tracks:
        assert abs(t["range_m"] - 7.0) < 1.0


def test_world_targets_collapse_in_bev(tmp_path, cfg, capsys):
    """World-fixed scatterers + moving platform: the generator evolves
    range/azimuth/Doppler from true geometry, the ego fit recovers the
    platform velocity, and dead-reckoned world accumulation collapses
    each scatterer to a tight cluster (vs the sensor-frame smear)."""
    from mmradar import cli
    from mmradar.io.capture import write_capture

    world = [(-3.0, 6.0), (1.5, 4.0), (4.0, 8.0), (-1.0, 9.0)]
    tgts = [SceneTarget(range_m=0.0, amplitude=2500.0, world_xy=w)
            for w in world]
    n_frames = 13
    cap = synthesize_capture(tgts, n_frames, cfg, noise_std=5.0, seed=21,
                             platform_velocity=V_EGO)
    path = tmp_path / "w.bin"
    write_capture(str(path), np.asarray(cap))
    out = tmp_path / "bev.csv"
    png = tmp_path / "bev.png"
    rc = cli.main(["bev", str(path), "--out", str(out),
                   "--plot", str(png)])
    assert rc in (0, None)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["event"] == "bev"
    assert rec["ego_fit_ok_frames"] >= n_frames - 3
    # platform covers ~ |v| * (F-1) * dt meters
    import math
    dt = cfg.num_chirps * cfg.chirp_interval_s
    want_dist = math.hypot(*V_EGO) * (n_frames - 2) * dt
    assert abs(rec["platform_distance_m"] - want_dist) < 0.4 * want_dist
    assert png.exists()

    rows = [l.split(",") for l in out.read_text().splitlines()[1:]]
    xw = np.array([float(r[1]) for r in rows])
    yw = np.array([float(r[2]) for r in rows])
    static = np.array([r[3] == "1" for r in rows])
    assert static.mean() > 0.8  # the scene IS the static world
    # each world target's accumulated points cluster around its true
    # position within bin-quantization noise; the sensor-frame smear
    # over the same capture is the platform displacement (~0.8 m)
    for wx, wy in world:
        d = np.hypot(xw - wx, yw - wy)
        sel = d < 1.2
        assert sel.sum() >= n_frames // 2, (wx, wy, d.min())
        spread = np.hypot(xw[sel] - xw[sel].mean(),
                          yw[sel] - yw[sel].mean()).max()
        assert spread < 0.7, (wx, wy, spread)
