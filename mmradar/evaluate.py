"""Detection-performance evaluation: Pd / Pfa curves for the CFAR family.

The reference has no evaluation story at all — its detector is an argmax
whose output is eyeballed (/root/reference/acceleration.cu:518-533).  A
detector that emits thresholded detections needs the two numbers that
characterize it: probability of detection (Pd) at a given target
strength and the realized false-alarm rate (Pfa) on target-free data —
the latter is the closed loop on every `cfar_alpha`/`go_so_cfar_alpha`
derivation in this repo (the solved alpha should REPRODUCE cfg.cfar_pfa
on exponential noise).

Methodology:

* Pfa: synthesize target-free frames (noise only), run the full
  pipeline, and count CFAR hits per cell via ``RDResult.num_hits``
  (the kernel's full-map count, not the top-K cap).  With clutter
  removal subtracting a same-distribution base frame the residual is
  noise-like, so the measured rate lands within small factors of
  cfg.cfar_pfa — not exactly: the map cells are FFT-correlated by the
  Hann window, which the standard CFAR derivation ignores.
* Pd: per amplitude point, synthesize frames with one target of known
  (range, velocity), run the pipeline, and score a detection when any
  valid output cell lands within ``tol_bins`` of the ground-truth
  (doppler, range) cell.

Consumed by ``cli eval`` and ``tests/test_evaluate.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mmradar.config import LIGHT_SPEED, DEFAULT_CONFIG, RadarConfig


def expected_bins(
    range_m: float, velocity_mps: float, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[int, int]:
    """Ground-truth (doppler_bin, range_bin) for a target — the inverse
    of ``models.rd_pipeline.cell_physics``."""
    rng_hz = range_m * 2.0 * cfg.slope_hz_per_s / LIGHT_SPEED
    r_bin = rng_hz / (cfg.sample_rate_hz / cfg.range_fft_size)
    dopp_hz = velocity_mps / (cfg.wavelength_m / 2.0)
    d_bin = dopp_hz * cfg.doppler_fft_size * cfg.slow_time_interval_s
    d_bin += cfg.doppler_fft_size // 2
    return int(round(d_bin)), int(round(r_bin))


@dataclass(frozen=True)
class EvalPoint:
    amplitude: float
    pd: float
    frames: int
    mean_hits: float


def measure_pfa(
    cfg: RadarConfig = DEFAULT_CONFIG,
    frames: int = 32,
    noise_std: float = 20.0,
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    n_integrate: int = 1,
    range_walk: bool = False,
    base_frames: int = 1,
) -> dict:
    """Realized false-alarm rate on target-free frames.

    Returns {'pfa_measured', 'pfa_configured', 'cells', 'hits',
    'repeat_cells'} — ``repeat_cells`` counts (doppler, range) cells
    that fired in two or more frames: with iid per-frame noise the
    expectation is ~C(F,2) * Pfa^2 * cells (essentially zero), so any
    excess measures the QUENCHED base-noise persistence (MIGRATION
    round-5 notes).  ``base_frames = K > 1`` averages K empty base
    frames (``prepare_base`` stack), cutting that quenched floor by
    1/K.
    ``n_integrate > 1`` measures the non-coherently-integrated detector
    (one decision per N-frame group).  With the round-5 Erlang-matched
    defaults the measured rate lands ON the configured Pfa under an
    independent-noise clutter mode ('mean'/mti2 — the documented
    pairing for integration); under BASE-frame subtraction the quenched
    base-noise realization correlates the N summed frames and inflates
    the integrated Pfa ~30x (gated in
    tests/test_integrate.py::test_integrated_pfa_bounded).
    """
    import jax.numpy as jnp

    from mmradar.io.synthetic import synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline

    k0 = max(1, int(base_frames))
    cap = synthesize_capture([], frames + k0, cfg, noise_std=noise_std,
                             seed=seed, n_base=k0)
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl)
    base = pipe.prepare_base(
        jnp.asarray(cap[0] if k0 == 1 else cap[:k0]))
    if n_integrate > 1:
        out = pipe.detect_integrated(jnp.asarray(cap[k0:]), base,
                                     n_integrate, range_walk)
    else:
        out = pipe.detect(jnp.asarray(cap[k0:]), base)
    hits = int(np.asarray(out.num_hits).sum())
    cells = ((frames // n_integrate) * cfg.doppler_fft_size
             * cfg.range_fft_size)
    valid = np.asarray(out.valid).astype(bool)
    db, rb = np.asarray(out.doppler_bin), np.asarray(out.range_bin)
    seen: dict = {}
    for f in range(valid.shape[0]):
        for k in range(valid.shape[1]):
            if valid[f, k]:
                key = (int(db[f, k]), int(rb[f, k]))
                seen[key] = seen.get(key, 0) + 1
    return {
        "pfa_measured": hits / cells,
        "pfa_configured": cfg.cfar_pfa,
        "cells": cells,
        "hits": hits,
        "repeat_cells": sum(1 for n in seen.values() if n >= 2),
    }


def pd_curve(
    cfg: RadarConfig = DEFAULT_CONFIG,
    amplitudes: tuple[float, ...] = (20.0, 40.0, 80.0, 160.0, 320.0),
    frames: int = 32,
    noise_std: float = 20.0,
    range_m: float = 6.0,
    velocity_mps: float = 2.0,
    azimuth_deg: float = 10.0,
    tol_bins: tuple[int, int] = (1, 1),
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    n_integrate: int = 1,
    range_walk: bool = False,
) -> list[EvalPoint]:
    """Pd over target amplitude for one target geometry.

    ``n_integrate > 1`` scores the non-coherently-integrated detector:
    one decision per N-frame group against the group's LAST frame's
    truth cell (the target must hold its cell across the group — the
    integration assumption itself).

    A frame scores as detected when any VALID output detection lands
    within ``tol_bins`` (doppler, range) of the ground-truth cell.
    The generator moves the target coherently (``io/synthetic.py``:
    range r0 + v * n * frame_interval at capture frame n), so the truth
    cell is propagated PER FRAME — a static frame-0 truth would
    misreport Pd < 1 on a working pipeline once the drift exceeds
    ``tol_bins`` (at 4 m/s and 32 frames that is ~1 m of pure motion).
    """
    import jax.numpy as jnp

    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline

    dt = cfg.num_chirps * cfg.chirp_interval_s
    # output frame f is capture frame f+1 (frame 0 = base frame)
    d_true = np.empty(frames, np.int64)
    r_true = np.empty(frames, np.int64)
    for f in range(frames):
        d_true[f], r_true[f] = expected_bins(
            range_m + velocity_mps * (f + 1) * dt, velocity_mps, cfg
        )
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl)
    points = []
    for i, amp in enumerate(amplitudes):
        cap = synthesize_capture(
            [SceneTarget(range_m=range_m, velocity_mps=velocity_mps,
                         azimuth_deg=azimuth_deg, amplitude=float(amp))],
            frames + 1, cfg, noise_std=noise_std, seed=seed + 17 * i,
        )
        base = pipe.prepare_base(jnp.asarray(cap[0]))
        if n_integrate > 1:
            out = pipe.detect_integrated(jnp.asarray(cap[1:]), base,
                                         n_integrate, range_walk)
            d_t = d_true[n_integrate - 1 :: n_integrate]
            r_t = r_true[n_integrate - 1 :: n_integrate]
        else:
            out = pipe.detect(jnp.asarray(cap[1:]), base)
            d_t, r_t = d_true, r_true
        valid = np.asarray(out.valid)
        d_bin = np.asarray(out.doppler_bin)
        r_bin = np.asarray(out.range_bin)
        ok = (
            valid
            & (np.abs(d_bin - d_t[:, None]) <= tol_bins[0])
            & (np.abs(r_bin - r_t[:, None]) <= tol_bins[1])
        )
        points.append(EvalPoint(
            amplitude=float(amp),
            pd=float(ok.any(axis=-1).mean()),
            frames=frames,
            mean_hits=float(np.asarray(out.num_hits).mean()),
        ))
    return points


def object_metrics(
    cfg: RadarConfig = DEFAULT_CONFIG,
    ranges_m: tuple[float, ...] = (3.0, 8.0),
    velocities_mps: tuple[float, ...] = (2.0, -4.0),
    amplitude: float = 2500.0,
    frames: int = 16,
    noise_std: float = 5.0,
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    tol_range_m: float = 1.0,
    tol_velocity_mps: float = 1.0,
) -> dict:
    """Object-level scoring of the clustering stage (``ops.cluster``).

    The cell-level Pd above says "some cell near the truth fired"; a
    tracker consumer cares about the OBJECT list: how many distinct
    objects were reported (vs the true count — raw top-K lists carry
    several cells per blob), and how accurate each object's centroid is.

    Per frame: cluster representatives are greedily matched to the true
    targets within (tol_range_m, tol_velocity_mps); a matched target
    counts toward ``object_pd``, and matched centroids accumulate the
    range/velocity RMSE.  Truth ranges are propagated per frame
    (r0 + v * (frame+1) * frame_interval — the generator's motion
    model, same as ``track_metrics``), so centroid RMSE measures the
    clustering stage, not target motion.

    Returns {'object_pd', 'mean_objects', 'true_objects',
    'mean_valid_detections' (pre-grouping, for the dedupe ratio),
    'range_rmse_m', 'velocity_rmse_mps', 'frames'}.
    """
    import jax.numpy as jnp

    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline

    targets = [
        SceneTarget(range_m=r, velocity_mps=v, azimuth_deg=0.0,
                    amplitude=amplitude)
        for r, v in zip(ranges_m, velocities_mps)
    ]
    cap = synthesize_capture(targets, frames + 1, cfg, noise_std=noise_std,
                             seed=seed)
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl)
    base = pipe.prepare_base(jnp.asarray(cap[0]))
    out, cl = pipe.detect_objects(jnp.asarray(cap[1:]), base)

    from mmradar.ops.cluster import representatives

    valid = np.asarray(out.valid)
    cid = np.asarray(cl.cluster_id)
    c_r = np.asarray(cl.centroid_range_m)
    c_v = np.asarray(cl.centroid_velocity_mps)
    rep_mask = representatives(valid, cid)

    matched = 0
    sq_r = []
    sq_v = []
    n_objects = []
    dt = cfg.num_chirps * cfg.chirp_interval_s
    for b in range(valid.shape[0]):
        # truth at output frame b == capture frame b+1 (generator motion)
        t_rng = [r + v * (b + 1) * dt
                 for r, v in zip(ranges_m, velocities_mps)]
        reps = list(np.flatnonzero(rep_mask[b]))
        n_objects.append(len(reps))
        # globally distance-ordered greedy (see track_metrics): fixed
        # truth order could steal a nearer truth's representative
        pairs = []
        for i, v_true in enumerate(velocities_mps):
            for k in reps:
                dr = abs(c_r[b, k] - t_rng[i])
                dv = abs(c_v[b, k] - v_true)
                if dr <= tol_range_m and dv <= tol_velocity_mps:
                    pairs.append((dr, i, k))
        pairs.sort(key=lambda x: x[0])
        used_i, used_k = set(), set()
        for dr, i, k in pairs:
            if i in used_i or k in used_k:
                continue
            used_i.add(i)
            used_k.add(k)
            matched += 1
            sq_r.append((c_r[b, k] - t_rng[i]) ** 2)
            sq_v.append((c_v[b, k] - velocities_mps[i]) ** 2)
    n_true = len(targets) * valid.shape[0]
    return {
        "ranges_m": list(ranges_m),
        "velocities_mps": list(velocities_mps),
        "amplitude": amplitude,
        "noise_std": noise_std,
        "object_pd": matched / max(1, n_true),
        "mean_objects": float(np.mean(n_objects)),
        "true_objects": len(targets),
        "mean_valid_detections": float(valid.sum(axis=-1).mean()),
        "range_rmse_m": float(np.sqrt(np.mean(sq_r))) if sq_r else None,
        "velocity_rmse_mps": float(np.sqrt(np.mean(sq_v))) if sq_v else None,
        "frames": frames,
    }


def track_metrics(
    cfg: RadarConfig = DEFAULT_CONFIG,
    ranges_m: tuple[float, ...] = (3.0, 8.0),
    velocities_mps: tuple[float, ...] = (2.0, -4.0),
    azimuths_deg: tuple[float, ...] = (15.0, -30.0),
    amplitude: float = 2500.0,
    frames: int = 32,
    noise_std: float = 5.0,
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    tracker_kind: str = "ekf",
    cluster: bool = True,
    tol_range_m: float = 1.5,
    tol_velocity_mps: float = 1.5,
) -> dict:
    """Track-level scoring: the tracker against analytic trajectories.

    ``pd_curve`` scores cells and ``object_metrics`` scores per-frame
    object lists; this closes the loop on the LAST pipeline stage, the
    multi-frame tracker.  The synthetic generator moves each target
    coherently (``io/synthetic.py``: range r0 + v * frame * interval,
    constant radial velocity and azimuth), so the truth at every frame
    is analytic and the standard multi-object tracking metrics follow:

    * ``track_pd`` — fraction of post-warmup truth-frames covered by a
      confirmed track within (tol_range_m, tol_velocity_mps); warmup is
      the tracker's confirmation window (first ``confirm_hits`` frames),
      during which no tracker can report.
    * ``id_switches`` — matched-track identity changes between
      consecutive covered frames of one truth (association errors).
    * ``fragments_per_truth`` — distinct track ids that ever covered
      each truth (1.0 = every truth held by one unbroken track).
    * ``range/velocity/azimuth RMSE`` — state error over covered frames
      (the filter's accuracy, on top of the detector's).
    * ``false_track_frames`` — confirmed-track frames matched to no
      truth.

    Detections feed the tracker exactly as ``cli track`` does: cluster
    representatives when ``cluster=True`` (one measurement per object),
    raw grouped peaks otherwise.
    """
    import jax.numpy as jnp

    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.models.tracker import (
        EKFConfig,
        EKFTracker,
        Tracker,
        TrackerConfig,
        detections_from_result,
        materialize_result,
    )

    targets = [
        SceneTarget(range_m=r, velocity_mps=v, azimuth_deg=a,
                    amplitude=amplitude)
        for r, v, a in zip(ranges_m, velocities_mps, azimuths_deg)
    ]
    cap = synthesize_capture(targets, frames + 1, cfg, noise_std=noise_std,
                             seed=seed)
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl)
    base = pipe.prepare_base(jnp.asarray(cap[0]))
    if cluster:
        from mmradar.ops.cluster import representatives

        out, cl = pipe.detect_objects(jnp.asarray(cap[1:]), base)
        out = materialize_result(out)
        out = out._replace(
            valid=representatives(out.valid, np.asarray(cl.cluster_id))
        )
    else:
        out = materialize_result(pipe.detect(jnp.asarray(cap[1:]), base))

    if tracker_kind == "ekf":
        tracker = EKFTracker(cfg, EKFConfig())
        warmup = EKFConfig().confirm_hits
    else:
        tracker = Tracker(cfg, TrackerConfig())
        warmup = TrackerConfig().confirm_hits

    dt = cfg.num_chirps * cfg.chirp_interval_s
    n_truth = len(targets)
    covered = [0] * n_truth            # post-warmup frames matched
    id_hist: list[list[int]] = [[] for _ in range(n_truth)]
    sq_r: list[float] = []
    sq_v: list[float] = []
    sq_a: list[float] = []
    false_frames = 0
    scoreable = 0                      # post-warmup frames per truth
    for f in range(frames):
        confirmed = tracker.update(detections_from_result(out, f))
        # capture frame f+1 (frame 0 is the target-free base frame)
        t_rng = [t.range_m + t.velocity_mps * (f + 1) * dt for t in targets]
        post_warmup = f >= warmup
        if post_warmup:
            scoreable += 1
        # globally distance-ordered greedy assignment (the same rule the
        # trackers use to associate): per-truth first-come order would
        # let truth 0 steal truth 1's track when both are inside both
        # gates — exactly the crossing scenario this metric exists to
        # score — and report spurious id switches on a correct tracker
        pairs = []
        for i, t in enumerate(targets):
            for tr in confirmed:
                dr = abs(tr.range_m - t_rng[i])
                dv = abs(tr.velocity_mps - t.velocity_mps)
                if dr <= tol_range_m and dv <= tol_velocity_mps:
                    pairs.append((dr, i, tr))
        pairs.sort(key=lambda x: x[0])
        matched_tracks: set[int] = set()
        matched_truths: set[int] = set()
        for dr, i, tr in pairs:
            if i in matched_truths or id(tr) in matched_tracks:
                continue
            matched_truths.add(i)
            matched_tracks.add(id(tr))
            id_hist[i].append(tr.track_id)
            if post_warmup:
                covered[i] += 1
                t = targets[i]
                sq_r.append((tr.range_m - t_rng[i]) ** 2)
                sq_v.append((tr.velocity_mps - t.velocity_mps) ** 2)
                da = (tr.azimuth_deg - t.azimuth_deg + 180.0) % 360.0 - 180.0
                sq_a.append(da ** 2)
        false_frames += sum(
            1 for tr in confirmed if id(tr) not in matched_tracks
        )
    switches = sum(
        sum(1 for a, b in zip(ids, ids[1:]) if a != b) for ids in id_hist
    )
    fragments = [len(set(ids)) for ids in id_hist]
    return {
        "tracker": tracker_kind,
        "ranges_m": list(ranges_m),
        "velocities_mps": list(velocities_mps),
        "azimuths_deg": list(azimuths_deg),
        "frames": frames,
        "warmup_frames": warmup,
        "track_pd": (sum(covered) / max(1, scoreable * n_truth)),
        "id_switches": switches,
        "fragments_per_truth": float(np.mean(fragments)) if fragments else 0.0,
        "range_rmse_m": float(np.sqrt(np.mean(sq_r))) if sq_r else None,
        "velocity_rmse_mps": float(np.sqrt(np.mean(sq_v))) if sq_v else None,
        "azimuth_rmse_deg": float(np.sqrt(np.mean(sq_a))) if sq_a else None,
        "false_track_frames": false_frames,
        "n_truths": n_truth,
    }
