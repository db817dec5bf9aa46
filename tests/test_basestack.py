"""Multi-frame base averaging (round 5).

Base-frame subtraction re-uses the base's noise realization in EVERY
processed frame, so a single noisy base doubles the per-cell noise
power AND quenches part of it (false alarms persist at fixed cells —
the MIGRATION round-5 finding).  ``prepare_base`` now accepts a
``(K, shorts)`` stack and averages: the quenched floor drops by 1/K,
so the post-subtraction mean cell power falls from ``2 sigma^2`` to
``(1 + 1/K) sigma^2`` — a directly measurable physical gate.
"""

import json

import numpy as np
import jax.numpy as jnp

from mmradar.config import RadarConfig
from mmradar.io.capture import write_capture
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import RDPipeline


def test_prepare_base_stack_is_mean_of_cubes(cfg):
    from mmradar.ops.decode import decode_to_cube

    cap = synthesize_capture([], 4, cfg, noise_std=10.0, seed=7, n_base=4)
    pipe = RDPipeline(cfg, max_detections=8)
    got = np.asarray(pipe.prepare_base(cap[:4]))
    want = np.asarray(jnp.mean(decode_to_cube(jnp.asarray(cap), cfg),
                               axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # single-frame form unchanged
    one = np.asarray(pipe.prepare_base(cap[0]))
    np.testing.assert_array_equal(
        one, np.asarray(decode_to_cube(jnp.asarray(cap[0]), cfg)))


def test_generator_n_base_keeps_base_frames_empty(cfg):
    tgt = SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=10.0,
                      amplitude=3000.0)
    cap = synthesize_capture([tgt], 10, cfg, noise_std=2.0, seed=3,
                             n_base=4)
    # base frames carry only clutter+noise; target frames carry the tone
    e = (cap.astype(np.float64) ** 2).mean(axis=1)
    assert e[:4].max() < 0.1 * e[4:].min(), e


def test_base_averaging_halves_noise_floor(cfg):
    """Post-subtraction mean cell power: 2 sigma^2 with a single noisy
    base -> (1 + 1/K) sigma^2 with a K-frame average (measured 0.5627x
    at K=8 vs the 0.5625 prediction)."""
    from mmradar.ops.fuseddft import fused_rd_planes

    cap = synthesize_capture([], 8 + 6, cfg, noise_std=20.0, seed=0,
                             n_base=8)
    pipe = RDPipeline(cfg, max_detections=8)
    means = {}
    for k in (1, 8):
        base = pipe.prepare_base(cap[0] if k == 1 else cap[:8])
        dr, di = fused_rd_planes(jnp.asarray(cap[8:]), base, cfg)
        means[k] = float(jnp.mean(dr * dr + di * di) * dr.shape[-3])
    ratio = means[8] / means[1]
    assert 0.5 < ratio < 0.62, ratio


def test_cli_base_frames_roundtrip(tmp_path, cfg):
    from mmradar import cli

    path = tmp_path / "k.bin"
    rc = cli.main(["generate", str(path), "--frames", "12",
                   "--base-frames", "4",
                   "--target", "5.0,2.0,10,2500", "--seed", "9"])
    assert rc == 0
    out = tmp_path / "d.jsonl"
    rc = cli.main(["detect", str(path), "--full", "--base-frames", "4",
                   "--out", str(out)])
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    # 12 frames, 4 base -> 8 records, numbered from the first target frame
    assert len(recs) == 8
    assert recs[0]["frame"] == 4
    assert any(abs(d["range_m"] - 5.0) < 1.0
               for r in recs for d in r["detections"])
    # too-large K is a usage error
    assert cli.main(["detect", str(path), "--full", "--base-frames",
                     "12"]) == 2


def test_cli_track_base_frames(tmp_path, cfg):
    from mmradar import cli

    path = tmp_path / "k.bin"
    assert cli.main(["generate", str(path), "--frames", "14",
                     "--base-frames", "6",
                     "--target", "5.0,2.0,10,2500", "--seed", "9"]) == 0
    out = tmp_path / "t.jsonl"
    assert cli.main(["track", str(path), "--base-frames", "6",
                     "--out", str(out)]) == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(recs) == 1  # one target, one confirmed track
    assert abs(recs[0]["history"][-1][0] - 5.0) < 1.0


# ---------------------------------------------------------------------------
# two-radar yaw-rate ego motion (round 5: the ROADMAP observability
# candidate) — unit math + the detect -> per-sensor fit -> joint solve
# chain end to end


def test_ego_motion_yaw_unit():
    from mmradar.golden import estimate_ego_motion_yaw, mount_rotation

    v = np.array([1.0, 6.0])
    omega = 0.2
    mounts = np.array([[0.5, 1.0, -30.0], [-0.5, 1.0, 25.0]])
    vs = []
    for mx, my, yaw in mounts:
        v_k = v + omega * np.array([-my, mx])     # lever arm
        vs.append(mount_rotation(yaw).T @ v_k)    # body -> sensor frame
    v_hat, w_hat, ok = estimate_ego_motion_yaw(np.array(vs), mounts)
    assert ok
    np.testing.assert_allclose(v_hat, v, atol=1e-12)
    assert abs(w_hat - omega) < 1e-12
    # same mounting position -> omega unobservable -> flagged
    _, _, ok = estimate_ego_motion_yaw(
        np.array(vs), np.array([[0.5, 1.0, -30.0], [0.5, 1.0, 25.0]]))
    assert not ok


def test_ego_motion_yaw_end_to_end(cfg, tmp_path):
    """detect -> per-sensor ego fit -> joint (v, omega) solve, through
    ``cli bev --second``.  Each sensor's capture carries that sensor's
    INSTANTANEOUS rigid-body velocity (v + omega x r_k, rotated to its
    frame) via the world-target generator — an honest test of the whole
    estimation chain (the generator cannot rotate a scene over time, so
    the per-frame Doppler geometry is what a turning platform's first
    frames present)."""
    import json

    from mmradar import cli
    from mmradar.golden import mount_rotation
    from mmradar.io.capture import write_capture
    from mmradar.io.synthetic import static_scene_targets, \
        synthesize_capture

    v = np.array([1.0, 6.0])
    omega = 0.15                                 # rad/s, ~8.6 deg/s
    mounts = [(0.6, 0.8, -20.0), (-0.6, 0.8, 20.0)]
    paths = []
    for i, (mx, my, yaw) in enumerate(mounts):
        v_k = mount_rotation(yaw).T @ (v + omega * np.array([-my, mx]))
        tgts = static_scene_targets(tuple(v_k), [4, 6, 8, 10],
                                    [-35, -10, 15, 40], 2500.0)
        cap = synthesize_capture(tgts, 6, cfg, noise_std=5.0, seed=21 + i,
                                 platform_velocity=tuple(v_k))
        p = tmp_path / f"s{i}.bin"
        write_capture(str(p), np.asarray(cap))
        paths.append(str(p))

    out = tmp_path / "bev.csv"
    rc = cli.main([
        "bev", paths[0], "--second", paths[1],
        "--mount=0.6,0.8,-20", "--mount2=-0.6,0.8,20",
        "--out", str(out),
    ])
    assert rc == 0
    assert out.exists() and len(out.read_text().splitlines()) > 4


def test_ego_motion_yaw_recovers_rate(cfg):
    """Numerical accuracy of the full chain: the joint fit recovers the
    injected (v, omega) from the two sensors' detected scenes."""
    import jax.numpy as jnp

    from mmradar import golden
    from mmradar.golden import mount_rotation
    from mmradar.io.synthetic import static_scene_targets, \
        synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.ops.egomotion import estimate_ego_motion

    v = np.array([1.0, 6.0])
    omega = 0.15
    mounts = [(0.6, 0.8, -20.0), (-0.6, 0.8, 20.0)]
    fits = []
    pipe = RDPipeline(cfg, max_detections=16)
    for i, (mx, my, yaw) in enumerate(mounts):
        v_k = mount_rotation(yaw).T @ (v + omega * np.array([-my, mx]))
        tgts = static_scene_targets(tuple(v_k), [4, 6, 8, 10],
                                    [-35, -10, 15, 40], 2500.0)
        cap = synthesize_capture(tgts, 4, cfg, noise_std=5.0, seed=31 + i,
                                 platform_velocity=tuple(v_k))
        base = pipe.prepare_base(cap[0])
        rd = pipe.detect(jnp.asarray(cap[1:]), base)
        em = estimate_ego_motion(rd.azimuth_deg, rd.velocity_mps,
                                 rd.valid, inlier_mps=0.5)
        assert bool(np.asarray(em.ok)[0])
        fits.append(np.asarray(em.velocity)[0])
    v_hat, w_hat, ok = golden.estimate_ego_motion_yaw(fits, mounts)
    assert ok
    # bin-quantized Doppler (~0.12 m/s) bounds the fit accuracy
    np.testing.assert_allclose(v_hat, v, atol=0.25)
    assert abs(w_hat - omega) < 0.1, w_hat


def test_cli_detect_resume_with_base_frames(tmp_path, cfg):
    """--resume seeks past both the base frames and the already-written
    records (resume == seek; the pipeline is stateless past the base)."""
    from mmradar import cli

    path = tmp_path / "k.bin"
    assert cli.main(["generate", str(path), "--frames", "12",
                     "--base-frames", "4",
                     "--target", "5.0,2.0,10,2500", "--seed", "9"]) == 0
    out = tmp_path / "d.jsonl"
    assert cli.main(["detect", str(path), "--full", "--base-frames", "4",
                     "--out", str(out)]) == 0
    first = out.read_text().splitlines()
    assert len(first) == 8
    # resume over a truncated file: only the missing records are appended
    out.write_text("\n".join(first[:5]) + "\n")
    assert cli.main(["detect", str(path), "--full", "--base-frames", "4",
                     "--out", str(out), "--resume"]) == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["frame"] for r in recs] == list(range(4, 12))
