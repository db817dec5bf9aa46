#!/usr/bin/env python
"""Speed-mode acceptance study: dft_precision='default' vs 'high'.

``dft_precision`` selects the matmul precision of the DFT-as-matmul
front-ends ('mxu', 'planar', 'fused'; the 'fft' front-end ignores it).
Whether the cheaper precision may carry a cell's headline is an
acceptance question this script answers: across >= --seeds seeds AND a
geometry sweep, compare the two modes' full detection output:

  * detection-set flips: symmetric difference of the
    {(frame, doppler_bin, range_bin)} sets (a detection present in one
    mode only);
  * bin exactness: for common detections, range/doppler bins are the
    SAME KEY by construction, so what remains is the interp sub-bin
    estimates and azimuth — max |delta| reported for both.

Acceptance criterion: zero flips on the default geometry at moderate
SNR; the study additionally reports near-threshold behavior (noise-only
frames at the CFAR operating point, where reduced-precision rounding CAN
flip marginal cells — those flips are the detector's own +/-1e-4-Pfa
band, not a pipeline bug, and are reported as a rate).  The numbers mean
something only on the card (``python scripts/speed_gate.py`` there); a
CPU run computes every precision in full f32.

Usage: python scripts/speed_gate.py [--seeds 20] [--frames 64]
       [--rd-impl fused] [--json out]
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")


def compare(cfg, cap, rd_impl, max_detections=16):
    """Run both modes on one capture; return flip/delta stats."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from mmradar.models.rd_pipeline import RDPipeline

    out = {}
    for prec in ("high", "default"):
        c = dataclasses.replace(cfg, dft_precision=prec)
        pipe = RDPipeline(c, max_detections=max_detections,
                          rd_impl=rd_impl)
        base = pipe.prepare_base(jnp.asarray(cap[0]))
        r = pipe.detect(jnp.asarray(cap[1:]), base)
        valid = np.asarray(r.valid).astype(bool)
        db = np.asarray(r.doppler_bin)
        rb = np.asarray(r.range_bin)
        az = np.asarray(r.azimuth_deg)
        ri = np.asarray(r.range_m_interp)
        vi = np.asarray(r.velocity_mps_interp)
        dets = {}
        for f in range(valid.shape[0]):
            for k in range(valid.shape[1]):
                if valid[f, k]:
                    dets[(f, int(db[f, k]), int(rb[f, k]))] = (
                        float(az[f, k]), float(ri[f, k]), float(vi[f, k])
                    )
        out[prec] = dets
    a, b = out["high"], out["default"]
    common = set(a) & set(b)
    flips = len(set(a) ^ set(b))
    d_az = max((abs(a[k][0] - b[k][0]) for k in common), default=0.0)
    d_ri = max((abs(a[k][1] - b[k][1]) for k in common), default=0.0)
    d_vi = max((abs(a[k][2] - b[k][2]) for k in common), default=0.0)
    return dict(n_high=len(a), n_default=len(b), n_common=len(common),
                flips=flips, max_az_delta=d_az,
                max_range_interp_delta=d_ri, max_vel_interp_delta=d_vi)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--rd-impl", default="fused",
                    choices=["mxu", "planar", "fused"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax

    from mmradar.config import RadarConfig
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"rd_impl={args.rd_impl}", file=sys.stderr)

    targets = [
        SceneTarget(3.0, 2.0, 20.0, amplitude=2500.0),
        SceneTarget(8.0, -4.0, -35.0, amplitude=1500.0),
        SceneTarget(12.0, 1.5, 10.0, amplitude=600.0),  # nearer the knee
    ]
    summary = {"seed_sweep": [], "geometry_sweep": [], "noise_only": []}

    cfg = RadarConfig()
    total_flips = 0
    total_frames = 0
    for seed in range(args.seeds):
        cap = synthesize_capture(targets, args.frames + 1, cfg,
                                 noise_std=8.0, seed=seed)
        r = compare(cfg, cap, args.rd_impl)
        r["seed"] = seed
        total_flips += r["flips"]
        total_frames += args.frames
        summary["seed_sweep"].append(r)
        print(f"seed {seed:2d}: {r}", file=sys.stderr)

    geometries = [
        dict(num_samples=64, num_chirps=64, num_rx=2),
        dict(num_samples=48, num_chirps=128),
        dict(num_samples=256, num_chirps=128),
        dict(num_tx=2),
        dict(num_samples=256, num_chirps=256),
    ]
    for geom in geometries:
        gcfg = RadarConfig(**geom)
        cap = synthesize_capture(targets, 17, gcfg, noise_std=8.0, seed=99)
        r = compare(gcfg, cap, args.rd_impl)
        r["geometry"] = geom
        total_flips += r["flips"]
        total_frames += 16
        summary["geometry_sweep"].append(r)
        print(f"geom {geom}: {r}", file=sys.stderr)

    # noise-only frames AT the operating point: every hit is marginal by
    # construction, so this measures the worst-case flip band (expected
    # nonzero; reported as a rate, not gated)
    for seed in range(5):
        cap = synthesize_capture([], args.frames + 1, cfg,
                                 noise_std=20.0, seed=1000 + seed)
        r = compare(cfg, cap, args.rd_impl)
        r["seed"] = 1000 + seed
        summary["noise_only"].append(r)
        print(f"noise seed {seed}: {r}", file=sys.stderr)

    summary["targeted_total"] = {
        "flips": total_flips, "frames": total_frames,
        "flips_per_frame": total_flips / max(1, total_frames),
    }
    noise_flips = sum(r["flips"] for r in summary["noise_only"])
    noise_dets = sum(max(r["n_high"], r["n_default"])
                     for r in summary["noise_only"])
    summary["noise_total"] = {
        "flips": noise_flips, "detections": noise_dets,
    }
    print(json.dumps(summary["targeted_total"]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
