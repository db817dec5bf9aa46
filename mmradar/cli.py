"""mmradar command-line interface.

The reference's binary runs both timing loops with a hardcoded input path
and no argv parsing (cudaBenchMarking.cpp:397-449); here:

  python -m mmradar.cli generate out.bin --frames 90 --target 5.0,2.0,15
  python -m mmradar.cli detect   cap.bin --out detections.jsonl
  python -m mmradar.cli bench    cap.bin [--native] [--batch 64]
  python -m mmradar.cli verify   cap.bin          # device vs float64 golden
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import deque

import numpy as np

from mmradar.config import LIGHT_SPEED, RadarConfig


def _build_cfg(args) -> RadarConfig:
    """RadarConfig from the shared pipeline knobs (when the subcommand
    defines them)."""
    kw = {}
    if getattr(args, "cfar_kind", None):
        kw["cfar_kind"] = args.cfar_kind
    if getattr(args, "dft_precision", None):
        kw["dft_precision"] = args.dft_precision
    if getattr(args, "window_kind", None):
        kw["window_kind"] = args.window_kind
    if getattr(args, "clutter", None):
        kw["clutter_mode"] = args.clutter
    if getattr(args, "num_tx", None):
        kw["num_tx"] = args.num_tx
    if getattr(args, "chirps", None):
        kw["num_chirps"] = args.chirps
    if getattr(args, "slope", None):
        kw["slope_hz_per_s"] = args.slope * 1e12
    if getattr(args, "cfar_pulses", None):
        kw["cfar_n_pulses"] = args.cfar_pulses
    if getattr(args, "range_edge_guard", None) is not None:
        kw["range_edge_guard"] = args.range_edge_guard
    cal_path = getattr(args, "cal", None)
    if cal_path:
        import json

        with open(cal_path) as f:
            doc = json.load(f)
        # cross-check the geometry the calibration was ESTIMATED under —
        # a length-only check would silently accept a correction whose
        # embedded steering reference belongs to a different array
        want_tx = kw.get("num_tx", 1)
        for field, have in (("num_rx", RadarConfig().num_rx),
                            ("num_tx", want_tx)):
            rec = doc.get(field)
            if rec is not None and int(rec) != int(have):
                raise ValueError(
                    f"calibration file {cal_path} was estimated at "
                    f"{field}={rec}, but this run uses {field}={have}; "
                    "re-run `cli calibrate` under the matching geometry"
                )
        if "tx_positions_wl" in doc:   # absent in pre-round-4 files
            rec_pos = doc["tx_positions_wl"]   # null = azimuth ULA
            rec_pos = (None if rec_pos is None
                       else [[float(x) for x in p] for p in rec_pos])
            wl = getattr(args, "elevated_tx", None)
            run_pos = None if wl is None else (
                [[t * RadarConfig().num_rx * 0.5, 0.0]
                 for t in range(want_tx - 1)] + [[0.0, float(wl)]])
            if rec_pos != run_pos:
                raise ValueError(
                    f"calibration file {cal_path} was estimated under TX "
                    f"geometry {rec_pos}, but this run uses {run_pos}; "
                    "the embedded steering reference would mis-correct "
                    "every angle — re-run `cli calibrate` under the "
                    "matching geometry"
                )
        kw["rx_cal"] = tuple(complex(re, im) for re, im in doc["rx_cal"])
    cfg = RadarConfig(**kw)
    wl = getattr(args, "elevated_tx", None)
    if wl is not None:
        # planar virtual array: the azimuth ULA keeps the first
        # num_tx-1 transmitters; the LAST TX sits at azimuth 0, raised
        # by wl wavelengths (the tested elevation geometry,
        # tests/test_mimo.py) — enables --refine 2d elevation
        import dataclasses

        if cfg.num_tx < 2:
            raise ValueError(
                "--elevated-tx needs --num-tx >= 2 (one azimuth TX plus "
                "the elevated one)"
            )
        pos = [(t * cfg.num_rx * cfg.rx_spacing_wavelengths, 0.0)
               for t in range(cfg.num_tx - 1)] + [(0.0, float(wl))]
        cfg = dataclasses.replace(cfg, tx_positions_wl=tuple(pos))
    return cfg


def _add_pipeline_flags(sp) -> None:
    sp.add_argument("--chirps", type=int, default=None,
                    help="chirps per frame (default 128; the reference "
                         "rebuilds for this, acceleration.cu:9)")
    sp.add_argument("--slope", type=float, default=None, metavar="MHZ_US",
                    help="chirp slope in MHz/us (default 5.987); higher "
                         "slope = finer range resolution")
    sp.add_argument("--rd-impl", default="auto",
                    choices=["auto", "fft", "mxu", "planar", "fused"],
                    help="range-Doppler front-end (auto = fft: FFT-library "
                         "transforms on the complex cube; mxu/planar/fused: "
                         "DFT as matmuls, see RDPipeline)")
    sp.add_argument("--cfar-kind", default=None,
                    choices=["ca", "os", "goca", "soca"],
                    help="cell-averaging (default), ordered-statistic, "
                         "greatest-of or smallest-of CA-CFAR")
    sp.add_argument("--window-kind", default=None,
                    choices=["hann", "hamming", "blackman",
                             "blackmanharris", "rect"],
                    help="FFT window (sidelobe level vs main-lobe width; "
                         "default hann)")
    sp.add_argument("--dft-precision", default=None,
                    choices=["high", "highest", "default"],
                    help="matmul precision of the mxu/planar/fused "
                         "front-ends ('fft' ignores it). On an H100: "
                         "'high' (the default) and 'default' are "
                         "TF32-class (~6e-5 of the RD map's peak vs "
                         "golden), 'highest' full f32 (~2e-7, ~1.4x the "
                         "fused front-end's cost)")
    sp.add_argument("--range-edge-guard", type=int, default=None,
                    metavar="BINS",
                    help="top-edge range bins excluded from detection "
                         "(wrapped window sidelobes of strong near "
                         "targets are persistent false alarms there). "
                         "Default: auto = 2*(guard+train) range bins; "
                         "0 = full-span detection")
    sp.add_argument("--base-frames", type=int, default=None, metavar="K",
                    help="use the first K frames (all empty-scene) as the "
                         "base, AVERAGED: base subtraction re-uses the "
                         "base's noise in every frame, so a single noisy "
                         "base makes false alarms persist at fixed cells "
                         "(ghost tracks); K frames cut that quenched "
                         "floor by 1/K. Default 1 (frame 0 only, the "
                         "reference convention). Record K empty frames, "
                         "or generate with --base-frames K")
    sp.add_argument("--cfar-pulses", type=int, default=None, metavar="N",
                    help="solve the CFAR alpha for Erlang-N cells. "
                         "Default: num_tx*num_rx, matching the RX-summed "
                         "per-frame map so the realized Pfa lands ON the "
                         "configured rate. Pass 1 for the legacy "
                         "exponential-cell alpha (conservative: measured "
                         "~0 false alarms where pfa=1e-4 expects ~52; "
                         "see MIGRATION.md)")
    sp.add_argument("--clutter", default=None,
                    choices=["auto", "base", "mean", "mti2", "mti3"],
                    help="slow-time clutter removal: 'auto' (base frame "
                         "when available, else mean-over-chirps), or "
                         "'mti2'/'mti3' pulse cancellers (static clutter "
                         "notched per CPI, no empty-scene capture needed)")
    sp.add_argument("--num-tx", type=int, default=None,
                    help="TDM-MIMO transmitters (must match the capture; "
                         "default 1 = the reference geometry)")
    sp.add_argument("--elevated-tx", type=float, default=None, nargs="?",
                    const=0.5, metavar="WL",
                    help="raise the last TX by WL wavelengths (default "
                         "0.5): planar virtual array, enables elevation "
                         "via --refine 2d (needs --num-tx >= 2)")
    sp.add_argument("--cal", default=None, metavar="CAL.json",
                    help="per-channel calibration file written by "
                         "`mmradar calibrate`: the complex correction "
                         "is applied to every virtual-array snapshot "
                         "before angle estimation (cfg.rx_cal)")


def _add_blank_flag(sp) -> None:
    sp.add_argument("--blank-interference", type=float, default=None,
                    metavar="K", nargs="?", const=8.0,
                    help="zero interference-burst samples before the "
                         "pipeline (|x| > K x frame median amplitude; "
                         "default K=8; ops/interference.py)")


def _add_refine_flag(sp) -> None:
    sp.add_argument("--refine", default=None, choices=["capon", "2d"],
                    help="high-resolution AoA on confirmed detections: "
                         "'capon' replaces the angle-FFT azimuth with the "
                         "MVDR estimate (RDPipeline.capon_refine); '2d' "
                         "adds joint azimuth/elevation (refine_2d; needs "
                         "an elevated TX for non-degenerate elevation)")


def _refined_azimuth(pipe, shorts, base, d_bin, r_bin, refine):
    """(azimuth_deg, elevation_deg|None) np arrays for detected cells."""
    import jax.numpy as jnp

    d_bin = jnp.asarray(np.asarray(d_bin, np.int32))
    r_bin = jnp.asarray(np.asarray(r_bin, np.int32))
    shorts = jnp.asarray(shorts)
    if refine == "capon":
        az = pipe.capon_refine(shorts, base, d_bin, r_bin)
        return np.asarray(az), None
    az, el = pipe.refine_2d(shorts, base, d_bin, r_bin)
    return np.asarray(az), np.asarray(el)


def _disambiguated(pipe, shorts, base, d_bin, r_bin):
    """(velocity_mps, azimuth_deg, hypothesis) np arrays, extended span."""
    import jax.numpy as jnp

    d_bin = jnp.asarray(np.asarray(d_bin, np.int32))
    r_bin = jnp.asarray(np.asarray(r_bin, np.int32))
    vel, az, hyp = pipe.disambiguate(jnp.asarray(shorts), base, d_bin, r_bin)
    return np.asarray(vel), np.asarray(az), np.asarray(hyp)


def _base_cube_and_start(args, capture, cfg):
    # (base_cube device c64, first_data_frame) honoring --base-frames:
    # the first K frames decode and AVERAGE into the base
    # (quenched-noise floor / K, see RDPipeline.prepare_base); data
    # frames start at K.  Decodes ON DEVICE from int16, so only the
    # int16 frames cross the host boundary.
    import jax.numpy as jnp

    from mmradar.ops.decode import decode_to_cube

    k = getattr(args, "base_frames", None) or 1
    if k >= len(capture):
        # usage error, matching the CLI's rc-2 convention (callers
        # return 2 on the None sentinel)
        print(f"error: --base-frames {k} leaves no frames (capture has "
              f"{len(capture)})", file=sys.stderr)
        return None, k
    cube = decode_to_cube(
        jnp.asarray(capture[:k] if k > 1 else capture[0]), cfg)
    if cube.ndim == 4:
        cube = jnp.mean(cube, axis=0)
    return cube, k


def _tracker_params(args, params):
    # apply --confirm-hits / --max-misses overrides onto the (possibly
    # None = kind-default) tracker params; returns 2 on a usage error
    ch = getattr(args, "confirm_hits", None)
    mm = getattr(args, "max_misses", None)
    if ch is None and mm is None:
        return params
    if (ch is not None and ch < 1) or (mm is not None and mm < 0):
        print("error: --confirm-hits needs >= 1 and --max-misses >= 0",
              file=sys.stderr)
        return 2
    import dataclasses as _dc

    from mmradar.models.tracker import EKFConfig, TrackerConfig

    if params is None:
        params = (EKFConfig() if getattr(args, "tracker", None) == "ekf"
                  else TrackerConfig())
    kw = {}
    if ch is not None:
        kw["confirm_hits"] = ch
    if mm is not None:
        kw["max_misses"] = mm
    return _dc.replace(params, **kw)


def _parse_target(spec: str):
    from mmradar.io.synthetic import SceneTarget

    parts = [float(x) for x in spec.split(",")]
    while len(parts) < 3:
        parts.append(0.0)
    amp = parts[3] if len(parts) > 3 else 2000.0
    elev = parts[4] if len(parts) > 4 else 0.0
    return SceneTarget(
        range_m=parts[0], velocity_mps=parts[1], azimuth_deg=parts[2],
        amplitude=amp, elevation_deg=elev,
    )


def cmd_generate(args) -> int:
    from mmradar.io.capture import write_capture
    from mmradar.io.synthetic import synthesize_capture

    from mmradar.io.synthetic import SceneTarget

    cfg = _build_cfg(args)
    targets = [_parse_target(t) for t in args.target]
    plat = (0.0, 0.0)
    if getattr(args, "platform", None):
        vx, vy = (float(v) for v in args.platform.split(","))
        plat = (vx, vy)
    for wt in getattr(args, "world_target", None) or []:
        parts = [float(v) for v in wt.split(",")]
        if len(parts) not in (2, 3):
            print("error: --world-target takes x,y[,amplitude]",
                  file=sys.stderr)
            return 2
        targets.append(SceneTarget(
            range_m=0.0, amplitude=parts[2] if len(parts) == 3 else 2000.0,
            world_xy=(parts[0], parts[1]),
        ))
    if not targets:
        targets = [_parse_target("5.0,2.0,15")]
    rx_response = None
    if getattr(args, "rx_imbalance", None):
        pairs = [p.split(":") for p in args.rx_imbalance.split(",")]
        if len(pairs) != cfg.num_rx or any(len(p) != 2 for p in pairs):
            print(f"error: --rx-imbalance needs {cfg.num_rx} gain:deg "
                  "pairs", file=sys.stderr)
            return 2
        rx_response = np.array([
            float(g) * np.exp(1j * np.deg2rad(float(ph))) for g, ph in pairs
        ])
    frames = synthesize_capture(
        targets, args.frames, cfg, noise_std=args.noise, seed=args.seed,
        interference_bursts=args.interference,
        rx_response=rx_response, platform_velocity=plat,
        chirp_level_motion=getattr(args, "chirp_motion", False),
        n_base=getattr(args, "base_frames", None) or 1,
    )
    write_capture(args.path, frames, cfg)
    print(f"wrote {args.frames} frames ({frames.nbytes} bytes) to {args.path}")
    return 0


def cmd_calibrate(args) -> int:
    """Estimate the per-channel correction from a capture of a single
    reflector at a known angle (float64 golden path end to end — this is
    an offline, once-per-array procedure, so precision beats speed)."""
    import json

    from mmradar import golden
    from mmradar.io.capture import read_capture

    cfg = _build_cfg(args)
    shorts = read_capture(args.path, cfg)
    if shorts.shape[0] < 2:
        print("error: calibration needs >= 2 frames (frame 0 is the "
              "empty-scene base)", file=sys.stderr)
        return 2
    if args.frames:
        shorts = shorts[: args.frames + 1]
    base = golden.decode_shorts(shorts[0], cfg)
    cube = golden.virtual_cube(
        golden.decode_shorts(shorts[1:], cfg) - base[None], cfg
    )
    rd = golden.range_doppler_map(cube, cfg)          # (N, V, D, R)
    power = (np.abs(rd) ** 2).sum(axis=1)
    snaps, dbins = [], []
    for f in range(rd.shape[0]):
        d, r = np.unravel_index(np.argmax(power[f]), power[f].shape)
        snaps.append(rd[f, :, d, r])
        dbins.append(d)
    snaps = golden.mimo_doppler_compensate(
        np.asarray(snaps), np.asarray(dbins), cfg
    )
    cal = golden.estimate_rx_cal(
        snaps, azimuth_deg=args.az, elevation_deg=args.el, cfg=cfg
    )
    doc = {
        "rx_cal": [[float(c.real), float(c.imag)] for c in cal],
        "num_rx": cfg.num_rx,
        "num_tx": cfg.num_tx,
        "tx_positions_wl": (None if cfg.tx_positions_wl is None
                            else [list(p) for p in cfg.tx_positions_wl]),
        "reference_azimuth_deg": args.az,
        "reference_elevation_deg": args.el,
        "frames_used": int(rd.shape[0]),
        "gain_db": [float(20 * np.log10(abs(c))) for c in cal],
        "phase_deg": [float(np.rad2deg(np.angle(c))) for c in cal],
    }
    out = args.out or "cal.json"
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out}: correction gains "
          + ", ".join(f"{g:+.2f} dB" for g in doc["gain_db"])
          + " | phases "
          + ", ".join(f"{p:+.1f} deg" for p in doc["phase_deg"]))
    return 0


def cmd_detect(args) -> int:
    import jax

    from mmradar.io.capture import read_capture
    from mmradar.models.range_detector import RangeDetector
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.utils.records import DetectionRecord, JsonlWriter

    from mmradar.utils.records import last_frame_index

    if args.resume and not args.out:
        print("error: --resume requires --out (records on stdout cannot be "
              "resumed)", file=sys.stderr)
        return 2

    if getattr(args, "cluster", False) and not args.full:
        print("error: --cluster requires --full (clustering groups the "
              "full pipeline's CFAR hit map)", file=sys.stderr)
        return 2
    cfg = _build_cfg(args)
    disambiguate = getattr(args, "disambiguate", False)
    if disambiguate:
        if not args.full:
            print("error: --disambiguate requires --full (the hypothesis "
                  "test runs on the RD pipeline's detections)",
                  file=sys.stderr)
            return 2
        if cfg.num_tx == 1:
            print("warning: --disambiguate is a no-op at num_tx=1 (no TDM "
                  "ambiguity; pass --num-tx to match the capture) -- "
                  "skipping it", file=sys.stderr)
            disambiguate = False
    ego_gate = getattr(args, "ego", None)
    if ego_gate is not None and not args.full:
        print("error: --ego requires --full (the fit runs on the RD "
              "pipeline's detections)", file=sys.stderr)
        return 2
    cmap_beta = getattr(args, "cmap", None)
    if cmap_beta is not None:
        if not args.full:
            print("error: --cmap requires --full (the clutter map runs "
                  "on the RD pipeline's power maps)", file=sys.stderr)
            return 2
        for bad in ("cluster", "integrate"):
            if getattr(args, bad, None):
                print(f"error: --cmap cannot be combined with --{bad}",
                      file=sys.stderr)
                return 2
    n_int = getattr(args, "integrate", None) or 1
    if n_int > 1:
        if not args.full:
            print("error: --integrate requires --full (integration sums "
                  "the RD pipeline's power maps)", file=sys.stderr)
            return 2
        for bad, why in (
            ("cluster", "clusters per-frame hit maps"),
            ("disambiguate", "re-tests per-frame snapshots"),
            ("refine", "re-estimates per-frame angles"),
            ("resume", "group alignment would drift across runs"),
        ):
            if getattr(args, bad, None):
                print(f"error: --integrate cannot be combined with "
                      f"--{bad} ({why})", file=sys.stderr)
                return 2
    want_points = bool(getattr(args, "points", None)
                       or getattr(args, "points_plot", None))
    if want_points and not args.full:
        print("error: --points/--points-plot require --full (points come "
              "from the RD pipeline's detections)", file=sys.stderr)
        return 2
    if getattr(args, "refine", None) and not args.full:
        print("error: --refine requires --full (it re-estimates the RD "
              "pipeline's detection angles)", file=sys.stderr)
        return 2
    if getattr(args, "keystone", False):
        if not args.full:
            print("error: --keystone requires --full (it transforms the "
                  "RD pipeline's radar cube)", file=sys.stderr)
            return 2
        if args.rd_impl not in ("auto", "fft", "mxu"):
            print(f"error: --keystone needs the complex-cube front-end "
                  f"(--rd-impl auto/fft/mxu), got {args.rd_impl!r}",
                  file=sys.stderr)
            return 2
    if getattr(args, "points", None) and args.resume:
        print("error: --points cannot be combined with --resume (point "
              "files are rewritten whole, so a resumed run would drop "
              "the frames already covered)", file=sys.stderr)
        return 2
    capture = read_capture(args.path, cfg)
    blank_k = getattr(args, "blank_interference", None)
    if blank_k is not None:
        import jax.numpy as jnp

        from mmradar.ops.interference import blank_interference

        blanked, n_bl = blank_interference(jnp.asarray(capture), k=blank_k)
        capture = np.asarray(blanked)
        n_bl = np.asarray(n_bl)
        print(f"interference blanking: {int(n_bl.sum())} samples zeroed "
              f"across {int((n_bl > 0).sum())} frames (K={blank_k})",
              file=sys.stderr)
    n_base = getattr(args, "base_frames", None) or 1
    if n_base >= len(capture):
        print(f"error: --base-frames {n_base} leaves no frames to detect "
              f"(capture has {len(capture)})", file=sys.stderr)
        return 2
    start_frame = n_base
    if args.resume and args.out:
        # resume = seek: the pipeline is stateless past the base frames
        start_frame = max(n_base, last_frame_index(args.out) + 1)
        if start_frame >= len(capture):
            print(f"{args.out} already covers all {len(capture)-1} frames")
            return 0
    # detect only the frames that still need records (resume == seek: the
    # pipeline is stateless past the base frame)
    todo = capture[start_frame:]
    if n_int > 1:
        kept = (len(todo) // n_int) * n_int
        if kept == 0:
            print(f"error: --integrate {n_int} needs at least {n_int} "
                  f"frames past the base frame (capture has {len(todo)})",
                  file=sys.stderr)
            return 2
        if kept < len(todo):
            print(f"--integrate {n_int}: trimming {len(todo) - kept} "
                  f"trailing frame(s) to a whole group", file=sys.stderr)
            todo = todo[:kept]
    det = RangeDetector(cfg)
    base_rx0 = det.prepare_base(capture[0])
    out = jax.tree.map(np.asarray, det.detect(todo, base_rx0))

    base_stack = capture[0] if n_base == 1 else capture[:n_base]

    cluster = getattr(args, "cluster", False)
    records = []
    points_rows = []
    cl = None
    if args.full:
        pipe = RDPipeline(cfg, max_detections=args.max_detections,
                          rd_impl=args.rd_impl,
                          keystone=getattr(args, "keystone", False))
        base = pipe.prepare_base(base_stack)
        if cluster:
            rd, cl = jax.tree.map(
                np.asarray, pipe.detect_objects(todo, base)
            )
        elif cmap_beta is not None:
            rd, _ = pipe.detect_cmap(todo, base, beta=cmap_beta,
                                     block=args.cmap_block)
            rd = jax.tree.map(np.asarray, rd)
        elif n_int > 1:
            rd = jax.tree.map(
                np.asarray,
                pipe.detect_integrated(todo, base, n_int,
                                       getattr(args, "walk", False)),
            )
        else:
            rd = jax.tree.map(np.asarray, pipe.detect(todo, base))
        if disambiguate:
            import jax.numpy as jnp

            vel_x, az_x, hyp_x = jax.tree.map(np.asarray, pipe.disambiguate(
                jnp.asarray(todo), base,
                jnp.asarray(rd.doppler_bin), jnp.asarray(rd.range_bin),
            ))
            # the interp estimate shifts by the same hypothesis offset
            # (constant per detection), so the two fields stay consistent
            rd = rd._replace(
                velocity_mps_interp=(rd.velocity_mps_interp
                                     + (vel_x - rd.velocity_mps)),
                velocity_mps=vel_x, azimuth_deg=az_x,
            )
        elev_r = None
        if getattr(args, "refine", None):
            az_r, elev_r = _refined_azimuth(
                pipe, todo, base, rd.doppler_bin, rd.range_bin, args.refine
            )
            if disambiguate:
                # wrapped targets: the refiner compensated with the
                # ALIASED Doppler — keep the hypothesis azimuth there
                az_r = np.where(hyp_x != 0, np.asarray(rd.azimuth_deg),
                                az_r)
            rd = rd._replace(azimuth_deg=az_r)
    ego = ego_static = ego_vground = None
    if args.full and ego_gate is not None:
        import jax.numpy as jnp

        from mmradar.ops.egomotion import (
            ego_compensated_velocity,
            estimate_ego_motion,
        )

        em = estimate_ego_motion(
            jnp.asarray(rd.azimuth_deg), jnp.asarray(rd.velocity_mps),
            jnp.asarray(rd.valid), inlier_mps=ego_gate,
        )
        ego = jax.tree.map(np.asarray, em)
        ego_static = ego.is_static
        ego_vground = np.asarray(ego_compensated_velocity(
            jnp.asarray(rd.azimuth_deg), jnp.asarray(rd.velocity_mps),
            jnp.asarray(ego.velocity),
        ))
        n_ok = int(ego.ok.sum())
        print(f"ego-motion: fit ok on {n_ok}/{len(ego.ok)} frames; "
              f"mean v = ({ego.velocity[ego.ok, 0].mean():.2f}, "
              f"{ego.velocity[ego.ok, 1].mean():.2f}) m/s"
              if n_ok else
              "ego-motion: no frame had a non-degenerate fit",
              file=sys.stderr)
    # one record per frame, or per integration group (--integrate N):
    # the record carries the group's LAST frame index and that frame's
    # range-parity fields, with detections from the summed map
    for j in range(len(todo) // n_int):
        pj = j * n_int + n_int - 1  # parity-path / frame index
        dets = None
        if args.full:
            dets = [
                {
                    "range_m": round(float(rd.range_m[j, k]), 4),
                    "velocity_mps": round(float(rd.velocity_mps[j, k]), 4),
                    "azimuth_deg": round(float(rd.azimuth_deg[j, k]), 2),
                    "power": float(rd.power[j, k]),
                    "range_m_interp": round(float(rd.range_m_interp[j, k]), 4),
                    "velocity_mps_interp":
                        round(float(rd.velocity_mps_interp[j, k]), 4),
                    **({"doppler_hypothesis": int(hyp_x[j, k])}
                       if disambiguate else {}),
                    **({"elevation_deg": round(float(elev_r[j, k]), 2)}
                       if elev_r is not None else {}),
                    **({
                        "is_static": bool(ego_static[j, k]),
                        "velocity_ground_mps":
                            round(float(ego_vground[j, k]), 4),
                    } if ego is not None else {}),
                    **({
                        "cluster_id": int(cl.cluster_id[j, k]),
                        "cluster_cells": int(cl.cells[j, k]),
                        "cluster_range_m":
                            round(float(cl.centroid_range_m[j, k]), 4),
                        "cluster_velocity_mps":
                            round(float(cl.centroid_velocity_mps[j, k]), 4),
                        "cluster_extent_bins": [
                            int(cl.extent_doppler_bins[j, k]),
                            int(cl.extent_range_bins[j, k]),
                        ],
                    } if cl is not None else {}),
                }
                for k in range(rd.valid.shape[1])
                if bool(rd.valid[j, k])
            ]
        records.append(
            DetectionRecord(
                frame=start_frame + pj,
                peak_bin=int(out.peak_bin[pj]),
                distance_m=float(out.distance_m[pj]),
                magnitude=float(out.peak_magnitude[pj]),
                detections=dets,
                ego=(None if ego is None else {
                    "vx_mps": round(float(ego.velocity[j, 0]), 3),
                    "vy_mps": round(float(ego.velocity[j, 1]), 3),
                    "ok": bool(ego.ok[j]),
                    "n_static": int(ego.n_inliers[j]),
                }),
            )
        )
        if want_points and dets:
            from mmradar.utils.points import detections_to_xyz

            for d in dets:
                x, y, z = detections_to_xyz(
                    d["range_m_interp"], d["azimuth_deg"],
                    d.get("elevation_deg"),
                )
                points_rows.append((start_frame + pj, float(x), float(y),
                                    float(z), d["velocity_mps"],
                                    d["power"]))
    mode = "a" if (args.resume and start_frame > 1) else "w"
    sink = open(args.out, mode) if args.out else sys.stdout
    JsonlWriter(sink).write_all(records)
    if args.out:
        sink.close()
        print(f"wrote {len(records)} records to {args.out}")
    if getattr(args, "points", None):
        from mmradar.utils.points import write_point_cloud

        n_pts = write_point_cloud(args.points, points_rows)
        print(f"wrote {n_pts} points to {args.points}")
    if getattr(args, "points_plot", None):
        from mmradar.viz import plot_point_cloud

        plot_point_cloud(points_rows, cfg, path=args.points_plot)
        print(f"wrote point-cloud plot to {args.points_plot}")
    return 0


def cmd_serve(args) -> int:
    """Live serving: DCA1000-style UDP stream -> JSONL detections + tracks.

    The first received frame is the empty-scene base frame (like frame 0
    of a capture file).  Subsequent frames are detected in micro-batches:
    every dispatch takes ALL frames already received (up to --serve-batch,
    zero added wait), so per-dispatch latency amortizes across however
    many frames the stream delivered meanwhile — where the per-dispatch
    cost dominates this multiplies served fps by the batch size.  One JSONL record per
    frame, tracker updated in arrival order.

    Multi-sensor: pass ``--port`` once per DCA1000 source.  Each source
    keeps its own base frame and tracker; frames from all sources share
    the compiled detection program, and records carry a ``source`` field.
    """
    import jax

    from mmradar.io.live import udp_frame_batches_multi
    from mmradar.models.rd_pipeline import RDPipeline, pack_detections
    from mmradar.models.tracker import EKFTracker, Tracker, group_peaks

    cfg = _build_cfg(args)
    disambiguate = getattr(args, "disambiguate", False)
    if disambiguate and cfg.num_tx == 1:
        print("warning: --disambiguate is a no-op at num_tx=1 (no TDM "
              "ambiguity; pass --num-tx to match the stream) -- skipping "
              "it (a per-batch no-op dispatch would double serve latency)",
              file=sys.stderr)
        disambiguate = False
    ego_gate = getattr(args, "ego", None)
    cmap_beta = getattr(args, "cmap", None)
    cmap_state: dict = {}   # per-source recursive background map
    n_int_arg = getattr(args, "integrate", None)
    if n_int_arg is not None and n_int_arg < 2:
        # reject rather than silently degrade to per-frame serving:
        # detect_integrated's own n >= 1 check never sees the value
        # because the serve loop only takes the integrate path at
        # n_int > 1 (matches the other flag guards' rc 2)
        print(f"error: --integrate needs a group size >= 2, got "
              f"{n_int_arg}", file=sys.stderr)
        return 2
    n_int = n_int_arg or 1
    if ((getattr(args, "confirm_hits", None) is not None
         and args.confirm_hits < 1)
            or (getattr(args, "max_misses", None) is not None
                and args.max_misses < 0)):
        print("error: --confirm-hits needs >= 1 and --max-misses >= 0",
              file=sys.stderr)
        return 2
    n_base = getattr(args, "base_frames", None) or 1
    walk = getattr(args, "walk", False)
    if n_int > 1:
        for bad, why in (
            ("disambiguate", "re-tests per-frame snapshots"),
            ("refine", "re-estimates per-frame angles"),
            ("cmap", "the clutter map is itself a multi-frame detector"),
        ):
            if getattr(args, bad, None):
                print(f"error: --integrate cannot be combined with "
                      f"--{bad} ({why})", file=sys.stderr)
                return 2
        if cfg.effective_clutter(has_base=True) == "base":
            # measured finding (rd_pipeline.detect_integrated docstring):
            # base subtraction repeats ONE noise realization in every
            # frame of a group, which integrates coherently and can push
            # Pd BELOW single-frame — integration wants fresh noise
            print("warning: --integrate under base-frame subtraction "
                  "integrates the base's noise realization coherently "
                  "(Pd can drop below single-frame); pass --clutter "
                  "mean or --clutter mti2", file=sys.stderr)
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl)
    blank_k = getattr(args, "blank_interference", None)
    if blank_k is not None:
        import jax.numpy as jnp

        from mmradar.ops.interference import blank_interference
    ports = args.port
    multi = len(ports) > 1

    def make_tracker():
        if args.tracker == "ekf":
            from mmradar.models.tracker import EKFConfig

            params = (EKFConfig(sigma_azimuth_deg=1.0) if args.refine
                      else EKFConfig())
        else:
            params = None
        params = _tracker_params(args, params)
        if params == 2:
            raise ValueError("invalid tracker confirmation flags")
        if args.tracker == "ekf":
            return EKFTracker(cfg, params)
        return Tracker(cfg) if params is None else Tracker(cfg, params)

    nb = max(1, args.serve_batch)
    # --integrate N: groups per dispatch; the dispatch shape stays static
    # (one compiled program) while the PENDING buffer below fixes group
    # alignment — groups are always N consecutive frames per source in
    # arrival order, however the stream chose to micro-batch them
    ng = max(1, nb // n_int)

    def warmup():
        # compile prepare_base + detect (shape-keyed) while the already-
        # bound sockets buffer incoming packets; without this the first
        # dispatch's compile stalls the receive loop into overflow
        warm = np.zeros((nb, cfg.shorts_per_frame), np.int16)
        if blank_k is not None:
            # compile the blanking program too (both shapes)
            jax.block_until_ready(blank_interference(
                jnp.asarray(warm), k=blank_k)[0])
            jax.block_until_ready(blank_interference(
                jnp.asarray(warm[0]), k=blank_k)[0])
        b0 = jax.block_until_ready(pipe.prepare_base(warm[0]))
        if n_base > 1:
            # the --base-frames stacked shape compiles its own program
            jax.block_until_ready(pipe.prepare_base(
                np.zeros((n_base, cfg.shorts_per_frame), np.int16)))
        if n_int > 1:
            # the integrate loop never dispatches the per-frame detect
            # program — warming it would only lengthen time-to-ready
            # (disambiguate/refine are rejected above at n_int > 1, so
            # nothing downstream needs the packed per-frame result)
            warm_g = np.zeros((ng * n_int, cfg.shorts_per_frame), np.int16)
            np.asarray(pack_detections(
                pipe.detect_integrated(warm_g, b0, n_int, walk)))
            print(json.dumps({"event": "ready"}), flush=True)
            return
        # full dispatch+materialize round trip: compiles detect AND the
        # packed-transfer program
        packed = np.asarray(pack_detections(pipe.detect(warm, b0)))
        if cmap_beta is not None:
            # both clutter-map variants the loop dispatches: the
            # self-seeding first batch and the carried-map steady state
            res, m_w = pipe.detect_cmap(warm, b0, beta=cmap_beta,
                                        m0=None, block=1)
            np.asarray(pack_detections(res))
            res, _ = pipe.detect_cmap(warm, b0, beta=cmap_beta,
                                      m0=m_w, block=1)
            np.asarray(pack_detections(res))
        if disambiguate:
            _disambiguated(pipe, warm, b0, packed[..., 7], packed[..., 8])
        if args.refine:
            # compile the refinement program too — a first-batch compile
            # inside the receive loop would overflow the reassembler
            _refined_azimuth(pipe, warm, b0, packed[..., 7], packed[..., 8],
                             args.refine)
        print(json.dumps({"event": "ready"}), flush=True)

    batches = udp_frame_batches_multi(
        ports, cfg, host=args.host,
        max_frames=None if args.max_frames < 0 else args.max_frames,
        timeout_s=args.timeout, max_batch=nb, on_bound=warmup,
    )
    bases: dict[int, object] = {}
    base_acc: dict[int, list] = {}  # --base-frames accumulation per source
    trackers: dict[int, object] = {}
    frame_no: dict[int, int] = {}  # per-source frame sequence numbers
    pending: dict[int, list] = {}  # --integrate: frames short of a group
    n = 0
    t_first = t_last = None
    # bounded reservoirs: one float per frame forever would grow without
    # limit in a long-lived server; the most recent window is what the
    # percentiles should describe anyway
    lat_ms: deque = deque(maxlen=65536)   # per-frame ingest->record latency
    fetch_ms: deque = deque(maxlen=65536)  # per-dispatch detect+fetch time
    blank_acc = 0  # device scalar once blanking runs; fetched at shutdown
    n_emitted = 0  # records emitted in the CURRENT batch (latency samples)

    def emit_record(src, row, elev_row=None, n_group=1):
        """One JSONL record from one packed result row: detections ->
        (optional) ego labeling -> tracker update -> print.  ``n_group``
        > 1 marks a --integrate group record (detections from the summed
        map; the frame counter advances by the whole group)."""
        nonlocal n, n_emitted
        n += n_group
        n_emitted += 1
        frame_no[src] = frame_no.get(src, 0) + n_group
        dets = [
            {
                "range_m": round(float(row[k, 0]), 4),
                "velocity_mps": round(float(row[k, 1]), 4),
                "azimuth_deg": round(float(row[k, 2]), 2),
                "power": float(row[k, 3]),
                "range_m_interp": round(float(row[k, 5]), 4),
                "velocity_mps_interp": round(float(row[k, 6]), 4),
                **(
                    {"elevation_deg": round(float(elev_row[k]), 2)}
                    if elev_row is not None else {}
                ),
            }
            for k in range(row.shape[0]) if row[k, 4] > 0.5
        ]
        dets = group_peaks(dets)
        ego_rec = None
        if ego_gate is not None:
            from mmradar import golden as _golden

            v_e, static, ok = _golden.estimate_ego_motion(
                np.array([d["azimuth_deg"] for d in dets]),
                np.array([d["velocity_mps"] for d in dets]),
                inlier_mps=ego_gate,
            )
            for d, st in zip(dets, static):
                d["is_static"] = bool(st)
                d["velocity_ground_mps"] = round(float(
                    _golden.ego_compensated_velocity(
                        d["azimuth_deg"], d["velocity_mps"], v_e
                    )), 4)
            ego_rec = {"vx_mps": round(float(v_e[0]), 3),
                       "vy_mps": round(float(v_e[1]), 3),
                       "ok": bool(ok),
                       "n_static": int(static.sum())}
            # the tracker sees movers only (a moving platform would
            # otherwise confirm one track per roadside scatterer);
            # records keep every detection, labeled
            track_in = [d for d, st in zip(dets, static)
                        if not st] if ok else dets
        else:
            track_in = dets
        confirmed = trackers[src].update(track_in)
        rec = {
            "frame": frame_no[src],
            **({"integrated": n_group} if n_group > 1 else {}),
            "detections": dets,
            **({"ego": ego_rec} if ego_rec is not None else {}),
            "tracks": [
                {"id": t.track_id, "range_m": round(t.range_m, 4),
                 "velocity_mps": round(t.velocity_mps, 4),
                 "azimuth_deg": round(t.azimuth_deg, 2)}
                for t in confirmed
            ],
        }
        if multi:
            rec["source"] = src
        print(json.dumps(rec), flush=True)

    for got in batches:
        t_recv = time.perf_counter()
        todo: dict[int, list] = {}
        for src, frame in got:
            if src not in bases:
                if blank_k is not None:
                    frame, nbl0 = blank_interference(
                        jnp.asarray(frame), k=blank_k)
                    blank_acc = blank_acc + jnp.sum(nbl0)
                # the first --base-frames frames per source are the
                # empty-scene base, AVERAGED (quenched-noise floor
                # drops by 1/K; see RDPipeline.prepare_base)
                acc = base_acc.setdefault(src, [])
                acc.append(np.asarray(frame))
                if len(acc) < n_base:
                    continue
                stack = acc[0] if n_base == 1 else np.stack(acc)
                bases[src] = jax.block_until_ready(
                    pipe.prepare_base(stack))
                del base_acc[src]
                trackers[src] = make_tracker()
                ev = {"event": "base_frame"}
                if n_base > 1:
                    ev["frames"] = n_base
                if multi:
                    ev["source"] = src
                print(json.dumps(ev), flush=True)
            else:
                todo.setdefault(src, []).append(frame)
        if not todo:
            continue
        n_emitted = 0
        if n_int > 1:
            # live non-coherent integration: frames accumulate in the
            # per-source PENDING buffer and dispatch in whole groups of
            # N consecutive frames — group alignment is fixed by arrival
            # order, independent of how the stream micro-batched them.
            # One record per group (detections from the summed map,
            # integration-matched CFAR alpha; see detect_integrated).
            for src, frames_src in todo.items():
                # pending carries each frame's ARRIVAL time so a group
                # completed several micro-batches after its first frame
                # arrived reports the full wait, not just the final
                # dispatch's share (latency = record time - the group's
                # OLDEST arrival; frames are in arrival order)
                pend = pending.setdefault(src, [])
                pend.extend((f, t_recv) for f in frames_src)
                while len(pend) >= n_int:
                    g = min(ng, len(pend) // n_int)
                    group_frames = [f for f, _ in pend[: g * n_int]]
                    t_oldest = [pend[j * n_int][1] for j in range(g)]
                    del pend[: g * n_int]
                    if t_first is None:
                        t_first = time.perf_counter()
                    stack = np.zeros((ng * n_int, cfg.shorts_per_frame),
                                     np.int16)
                    stack[: g * n_int] = np.stack(group_frames)
                    t_x = time.perf_counter()
                    if blank_k is not None:
                        stack, nbl = blank_interference(
                            jnp.asarray(stack), k=blank_k)
                        blank_acc = blank_acc + jnp.sum(nbl)
                    out = np.array(pack_detections(pipe.detect_integrated(
                        stack, bases[src], n_int, walk)))
                    fetch_ms.append(1e3 * (time.perf_counter() - t_x))
                    for j in range(g):
                        emit_record(src, out[j], n_group=n_int)
                    t_last = time.perf_counter()
                    lat_ms.extend(1e3 * (t_last - t0_g)
                                  for t0_g in t_oldest)
            continue
        if t_first is None:
            t_first = time.perf_counter()
        for src, frames_src in todo.items():
            # pad to the static batch shape: one compiled program for all
            # sizes and all sources
            stack = np.zeros((nb, cfg.shorts_per_frame), np.int16)
            stack[: len(frames_src)] = np.stack(frames_src)
            # single packed transfer: per-leaf materialization costs one
            # device sync + copy each (see pack_detections).  np.array (not
            # asarray): jax's cached npy view is read-only and --refine
            # writes the azimuth column in place.
            # this window covers dispatch + on-chip compute + the packed
            # result's D2H (np.array blocks on all three) — labeled
            # detect_fetch, NOT transfer: the copy's share cannot be
            # isolated host-side without an extra fence per dispatch
            t_x = time.perf_counter()
            if blank_k is not None:
                # device array in, device array out: no host round trip;
                # the blanked count accumulates as a device scalar and is
                # fetched ONCE at shutdown (a per-dispatch fetch would add
                # a device sync to every batch)
                stack, nbl = blank_interference(jnp.asarray(stack),
                                                k=blank_k)
                blank_acc = blank_acc + jnp.sum(nbl)
            if cmap_beta is not None:
                # block=1 alpha: serve's map updates once per dispatch
                # with varying micro-batch sizes, and the per-frame
                # (largest) alpha keeps the realized Pfa at or below
                # the configured rate for any batch size
                res, m_out = pipe.detect_cmap(
                    stack, bases[src], beta=cmap_beta,
                    m0=cmap_state.get(src), block=1,
                )
                cmap_state[src] = m_out   # stays device-resident
                out = np.array(pack_detections(res))
            else:
                out = np.array(pack_detections(pipe.detect(stack,
                                                           bases[src])))
            fetch_ms.append(1e3 * (time.perf_counter() - t_x))
            elev = None
            hyp = None
            if disambiguate:
                vel_x, az_x, hyp = _disambiguated(
                    pipe, stack, bases[src], out[..., 7], out[..., 8]
                )
                # the interp estimate shifts by the same hypothesis
                # offset, keeping the two velocity fields consistent
                out[..., 6] += vel_x - out[..., 1]
                out[..., 1] = vel_x
                out[..., 2] = az_x
            if args.refine:
                az, elev = _refined_azimuth(
                    pipe, stack, bases[src], out[..., 7], out[..., 8],
                    args.refine,
                )
                if hyp is not None:
                    # for wrapped targets the refiner compensated with
                    # the ALIASED Doppler (decohered array) — keep the
                    # winning hypothesis's azimuth there
                    az = np.where(hyp != 0, out[..., 2], az)
                out[..., 2] = az
            for j in range(len(frames_src)):
                emit_record(src, out[j],
                            None if elev is None else elev[j])
        t_last = time.perf_counter()
        # every frame of this dispatch became a record now; its latency is
        # measured from batch delivery (the reassembler completes frames
        # sub-ms before the yield, so this is ingest->result to within the
        # batching granularity the stream itself chose)
        lat_ms.extend([1e3 * (t_last - t_recv)] * n_emitted)
    n_drop = sum(len(v) for v in pending.values())
    if n_drop:
        print(f"# --integrate {n_int}: dropped {n_drop} trailing frame(s) "
              f"short of a full group", file=sys.stderr)
    if lat_ms:
        q = _percentiles(lat_ms, (50, 90, 99))
        qx = _percentiles(fetch_ms, (50, 99))
        stats = {
            "event": "latency_stats",
            "frames": n,
            "p50_ms": q[0], "p90_ms": q[1], "p99_ms": q[2],
            "max_ms": round(max(lat_ms), 3),
            "detect_fetch_p50_ms": qx[0], "detect_fetch_p99_ms": qx[1],
        }
        if blank_k is not None:
            stats["blanked_samples"] = int(np.asarray(blank_acc))
        print(json.dumps(stats), flush=True)
    if t_first is not None and t_last is not None and t_last > t_first:
        dt = t_last - t_first
        print(f"# served {n} frames in {dt:.2f}s = {n/dt:.1f} fps "
              f"(first dispatch to last record; excludes the trailing "
              f"socket-timeout wait)", file=sys.stderr)
    else:
        print(f"# served {n} frames", file=sys.stderr)
    return 0


def _percentiles(xs: list[float], qs: tuple[int, ...]) -> list[float]:
    """Nearest-rank percentiles, rounded for JSONL emission.

    The reference prints a per-frame timing line unconditionally
    (acceleration.cu:533) but never aggregates it; real-time radar wants
    the p50/p99 frame-to-detection latency, not just throughput.
    """
    s = sorted(xs)
    return [
        round(s[min(len(s) - 1, max(0, -(-q * len(s) // 100) - 1))], 3)
        for q in qs
    ]


def cmd_replay(args) -> int:
    """Stream a capture file as DCA1000 raw-mode UDP datagrams — the
    sensor side of ``cli serve`` (demo/integration without hardware; the
    reference can only read its hardcoded file, cudaBenchMarking.cpp:224).

    Paced per frame at ``--fps``; frame 0 goes first so the receiver's
    base-frame convention holds.
    """
    import socket

    from mmradar.io.capture import read_capture
    from mmradar.io.live import make_packets

    cfg = _build_cfg(args)
    frames = read_capture(args.path, cfg)
    n = len(frames) if args.max_frames < 0 else min(args.max_frames, len(frames))
    packets = make_packets(frames[:n])
    per_frame = -(-len(packets) // n)
    interval = 1.0 / args.fps if args.fps > 0 else 0.0

    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t0 = time.perf_counter()
    for i in range(n):
        for pkt in packets[i * per_frame : (i + 1) * per_frame]:
            tx.sendto(pkt, (args.host, args.port))
        if interval:
            # pace against the wall clock, not per-frame sleeps (drift-free)
            lag = t0 + (i + 1) * interval - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
    tx.close()
    dt = time.perf_counter() - t0
    print(f"replayed {n} frames ({len(packets)} datagrams) to "
          f"{args.host}:{args.port} in {dt:.2f}s = {n/max(dt,1e-9):.1f} fps",
          file=sys.stderr)
    return 0


def cmd_track(args) -> int:
    """Detect + multi-frame tracking; prints confirmed object tracks."""
    import jax

    from mmradar.io.capture import read_capture
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.models.tracker import track_capture

    from mmradar.models.tracker import materialize_result

    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    blank_k = getattr(args, "blank_interference", None)
    if blank_k is not None:
        import jax.numpy as jnp

        from mmradar.ops.interference import blank_interference

        capture = np.asarray(
            blank_interference(jnp.asarray(capture), k=blank_k)[0]
        )
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl)
    n_base = getattr(args, "base_frames", None) or 1
    if n_base >= len(capture):
        print(f"error: --base-frames {n_base} leaves no frames to track "
              f"(capture has {len(capture)})", file=sys.stderr)
        return 2
    base = pipe.prepare_base(capture[0] if n_base == 1
                             else capture[:n_base])
    capture = capture[n_base - 1:]   # keep [0] slot semantics below
    if getattr(args, "cluster", False):
        # one measurement per OBJECT: keep only each hit-blob's strongest
        # detection so multi-cell blobs don't spawn duplicate tracks
        res, cl = pipe.detect_objects(capture[1:], base)
        from mmradar.ops.cluster import representatives

        is_rep = representatives(np.asarray(res.valid),
                                 np.asarray(cl.cluster_id))
        out = materialize_result(res)._replace(valid=is_rep)
    else:
        out = materialize_result(pipe.detect(capture[1:], base))
    disambiguate = getattr(args, "disambiguate", False)
    if disambiguate and cfg.num_tx == 1:
        print("warning: --disambiguate is a no-op at num_tx=1 (no TDM "
              "ambiguity; pass --num-tx to match the capture) -- "
              "skipping it", file=sys.stderr)
        disambiguate = False
    hyp = None
    if disambiguate:
        import jax.numpy as jnp

        vel_x, az_x, hyp = jax.tree.map(np.asarray, pipe.disambiguate(
            jnp.asarray(capture[1:]), base,
            jnp.asarray(out.doppler_bin), jnp.asarray(out.range_bin),
        ))
        out = out._replace(velocity_mps=vel_x, azimuth_deg=az_x)
    params = None
    if args.refine:
        az, _ = _refined_azimuth(pipe, capture[1:], base, out.doppler_bin,
                                 out.range_bin, args.refine)
        if hyp is not None:
            # wrapped targets: the refiner compensated with the ALIASED
            # Doppler (decohered virtual array) — keep the winning
            # hypothesis's azimuth for them
            az = np.where(hyp != 0, np.asarray(out.azimuth_deg), az)
        out = out._replace(azimuth_deg=az)
        if args.tracker == "ekf":
            # the refined azimuth is sharper than the 4-element angle-FFT
            # grid; tighten the EKF's measurement noise accordingly
            from mmradar.models.tracker import EKFConfig

            params = EKFConfig(sigma_azimuth_deg=1.0)
    ego = None
    ego_gate = getattr(args, "ego", None)
    if ego_gate is not None:
        # moving-platform tracking: fit the ego velocity per frame and
        # drop the static world from the measurement stream — trackers
        # then spend their gates on genuine movers instead of confirming
        # one track per roadside scatterer
        import jax.numpy as jnp

        from mmradar.ops.egomotion import estimate_ego_motion

        em = estimate_ego_motion(
            jnp.asarray(out.azimuth_deg),
            jnp.asarray(out.velocity_mps), jnp.asarray(out.valid),
            inlier_mps=ego_gate,
        )
        ego = jax.tree.map(np.asarray, em)
        keep = np.asarray(out.valid) & ~ego.is_static
        n_drop = int((np.asarray(out.valid) & ego.is_static).sum())
        out = out._replace(valid=keep)
        n_ok = int(ego.ok.sum())
        print(f"ego-motion: fit ok on {n_ok}/{len(ego.ok)} frames, "
              f"{n_drop} static detections dropped before tracking",
              file=sys.stderr)
    params = _tracker_params(args, params)
    if params == 2:
        return 2
    tracker = track_capture(out, cfg, kind=args.tracker, params=params)
    tracks = [t for t in tracker.tracks if t.confirmed]
    for t in tracks:
        rec = {
            "track_id": t.track_id,
            "range_m": round(t.range_m, 4),
            "velocity_mps": round(t.velocity_mps, 4),
            "azimuth_deg": round(t.azimuth_deg, 2),
            "hits": t.hits,
        }
        if ego is not None:
            ok_v = ego.velocity[ego.ok]
            if len(ok_v):
                vx, vy = float(ok_v[:, 0].mean()), float(ok_v[:, 1].mean())
                az = np.deg2rad(t.azimuth_deg)
                rec["velocity_ground_mps"] = round(
                    t.velocity_mps + vx * float(np.sin(az))
                    + vy * float(np.cos(az)), 4)
        print(json.dumps(rec))
    if getattr(args, "out", None):
        with open(args.out, "w") as f:
            for t in tracks:
                f.write(json.dumps({
                    "track_id": t.track_id,
                    "hits": t.hits,
                    "history": [[round(r, 4), round(v, 4), round(a, 2)]
                                for r, v, a in t.history],
                }) + "\n")
        print(f"wrote {len(tracks)} track histories to {args.out}",
              file=sys.stderr)
    if getattr(args, "plot", None):
        from mmradar.viz import plot_tracks

        plot_tracks(tracker, cfg, path=args.plot)
        print(f"wrote track plot to {args.plot}", file=sys.stderr)
    print(f"# {len(tracks)} confirmed tracks over {len(capture)-1} frames",
          file=sys.stderr)
    return 0


def _print_native_report(t: dict) -> None:
    n = t["frames"]
    print("CPU Timing (native golden model)")
    print(
        f"Total Time for {n} frames {1000*t['total']:.5f} ms "
        f"averaged {n/t['total']:.5f} FPS"
    )
    print(f"Total FFT time {1000*t['fft']:.5f} ms averaged "
          f"{1000*t['fft']/n:.5f} ms/frame")
    print(f"Total Reshape + Extension time {1000*t['preprocess']:.5f} ms "
          f"averaged {1000*t['preprocess']/n:.5f} ms/frame")
    print(f"Total findMax time {1000*t['findmax']:.5f} ms averaged "
          f"{1000*t['findmax']/n:.5f} ms/frame")


def _cmd_bench_compare(args, cfg) -> int:
    """One-shot native-golden <-> device comparative benchmark with the
    per-frame verification loop ENABLED — the working version of the
    reference's ``main()`` (cudaBenchMarking.cpp:397-449 runs cpuTiming
    then cudaTiming; the CPU<->GPU comparison loop is written but
    commented out at :410-419 with a 1e-5 m gate).  Exit code reflects
    the verification gate."""
    import jax

    from mmradar import native
    from mmradar.io.capture import read_capture
    from mmradar.models.range_detector import RangeDetector
    from mmradar.utils.timing import StageTimings, fence, time_fn

    # ---- pass 1: native C++ float64 golden (reference cpuTiming) --------
    dists, t = native.process_capture(args.path, cfg)
    _print_native_report(t)
    n = t["frames"]

    # ---- pass 2: device pipeline, same capture (reference cudaTiming) ---
    capture = read_capture(args.path, cfg)
    det = RangeDetector(cfg)
    base = det.prepare_base(capture[0])
    batch = jax.device_put(np.asarray(capture[1:]))
    fence(det.detect(batch, base))  # compile + warm
    t0 = time.perf_counter()
    out = det.detect(batch, base)
    fence(out)
    total = time.perf_counter() - t0
    padded = det.preprocess(batch, base)
    spec = det.fft_stage(padded)
    st = StageTimings(
        preprocess=time_fn(det.preprocess, batch, base, iters=5),
        fft=time_fn(det.fft_stage, padded, iters=5),
        detect=time_fn(det.detect_stage, spec, iters=5),
        total=total,
        frames=n,
    )
    print(f"Device Timing (range-parity, batch={n})")
    print(st.report())

    # ---- pass 3: per-frame verification, ENABLED ------------------------
    got = jax.tree.map(np.asarray, out)
    fail_rel = 0
    within_ref_gate = 0
    for i in range(n):
        cpu_d = float(dists[i])
        dev_d = float(got.distance_m[i])
        if abs(dev_d - cpu_d) < 1e-5:  # the reference's own (disabled) gate
            within_ref_gate += 1
        if abs(dev_d - cpu_d) > max(1e-3 * cpu_d, 1e-9):
            fail_rel += 1
            print(f"FRAME {i+1} MISMATCH: native {cpu_d:.6f} m vs "
                  f"device {dev_d:.6f} m")
        if args.per_frame:
            print(f"frame[{i+1}] native {cpu_d:.6f} m | device {dev_d:.6f} m | "
                  f"inner {1000*total/n:.3f} ms/frame")
    print(f"verification: {n - fail_rel}/{n} frames within 1e-3 relative "
          f"(gate: PASS)" if fail_rel == 0 else
          f"verification: {fail_rel}/{n} frames FAILED the 1e-3 gate")
    print(f"reference 1e-5 m absolute gate (cudaBenchMarking.cpp:414): "
          f"{within_ref_gate}/{n} frames within "
          f"(bin-exact matches are identical after quantization)")
    return 1 if fail_rel else 0


def cmd_bench(args) -> int:
    cfg = _build_cfg(args)
    if args.compare:
        return _cmd_bench_compare(args, cfg)
    if args.native:
        from mmradar import native

        _, t = native.process_capture(args.path, cfg)
        _print_native_report(t)
        return 0

    import jax

    from mmradar.models.range_detector import RangeDetector
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.parallel.stream import FrameStreamer, stream_detect
    from mmradar.utils.timing import StageTimings

    det = RangeDetector(cfg)
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl)
    streamer = FrameStreamer(args.path, batch=args.batch, cfg=cfg)
    base_rx0 = det.prepare_base(streamer.base_frame)
    base_cube = pipe.prepare_base(streamer.base_frame)

    from mmradar.utils.timing import fence

    fn = (
        (lambda b: pipe.detect(b, base_cube))
        if args.full
        else (lambda b: det.detect(b, base_rx0))
    )
    # warmup/compile on the first batch
    first = next(iter(streamer))
    fence(fn(first))

    import contextlib

    profile_ctx = (
        jax.profiler.trace(args.profile)
        if args.profile
        else contextlib.nullcontext()
    )
    with profile_ctx:
        t0 = time.perf_counter()
        results = stream_detect(streamer, fn)
        fence([r[0] for r in results])
        total = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    n = len(streamer.frames)
    mode = "range-Doppler-CFAR-AoA" if args.full else "range-parity"
    print(f"Device Timing ({mode}, batch={args.batch})")

    if args.stages:
        from mmradar.utils.timing import time_fn

        b = jax.device_put(np.asarray(first))
        nb = args.batch
    if args.stages and args.full:
        # full-pipeline decomposition on one resident batch: the resolved
        # front-end's maps (decode + range + Doppler + power + CFAR) vs
        # the detection tail (top-K + interp + AoA) that detect() adds
        print(
            f"Total Time for {n} frames {1000*total:.5f} ms "
            f"averaged {n/total:.5f} FPS"
        )
        resolved = pipe._resolve_rd_impl()
        t_maps = time_fn(pipe.maps, b, base_cube, iters=5)
        t_det = time_fn(pipe.detect, b, base_cube, iters=5)
        tail = max(0.0, t_det - t_maps)
        print(f"Front-end maps rd_impl={resolved!r} (decode+range+Doppler"
              f"+power+CFAR) {1000*t_maps:.5f} ms averaged "
              f"{1000*t_maps/nb:.5f} ms/frame")
        print(f"Detection tail (top-K + physics + MIMO comp + angle FFT) "
              f"{1000*tail:.5f} ms averaged {1000*tail/nb:.5f} ms/frame")
    elif args.stages:
        # reference-format 4-bucket breakdown (non-overlapping, fenced) on
        # one resident batch — cudaBenchMarking.cpp:328-331's report
        padded = det.preprocess(b, base_rx0)
        spec = det.fft_stage(padded)
        t_pre = time_fn(det.preprocess, b, base_rx0, iters=5)
        t_fft = time_fn(det.fft_stage, padded, iters=5)
        t_det = time_fn(det.detect_stage, spec, iters=5)
        st = StageTimings(
            preprocess=t_pre, fft=t_fft, detect=t_det,
            total=total * nb / max(n, 1), frames=nb,
        )
        print(st.report())
    else:
        st = StageTimings(total=total, frames=n)
        print(
            f"Total Time for {n} frames {1000*total:.5f} ms "
            f"averaged {st.fps:.5f} FPS"
        )

    if args.latency:
        # dispatch->materialized-result latency distribution, the serving
        # picture (throughput above amortizes; a real-time consumer sees
        # this).  One resident batch, packed single-transfer results —
        # the same program ``cli serve`` dispatches.
        from mmradar.models.rd_pipeline import pack_detections

        b = jax.device_put(np.asarray(first))
        lat = []
        np.asarray(pack_detections(pipe.detect(b, base_cube)))  # warm
        for _ in range(20):
            t0 = time.perf_counter()
            np.asarray(pack_detections(pipe.detect(b, base_cube)))
            lat.append(1e3 * (time.perf_counter() - t0))
        q = _percentiles(lat, (50, 90, 99))
        print(f"dispatch latency over 20 reps (batch={args.batch}, "
              f"packed transfer): p50 {q[0]} ms, p90 {q[1]} ms, "
              f"p99 {q[2]} ms, max {max(lat):.3f} ms")
    return 0


def cmd_eval(args) -> int:
    """Pd/Pfa detection-performance evaluation (mmradar/evaluate.py):
    realized false-alarm rate on target-free frames (the closed loop on
    the CFAR alpha derivations) and a detection-probability curve over
    target amplitude.  The reference has no evaluation story at all
    (argmax, eyeballed: acceleration.cu:518-533)."""
    from mmradar.evaluate import measure_pfa, pd_curve

    cfg = _build_cfg(args)
    n_int = args.integrate or 1
    if n_int > 1 and args.frames % n_int:
        print(f"error: --frames {args.frames} must be a multiple of "
              f"--integrate {n_int}", file=sys.stderr)
        return 2
    pfa = measure_pfa(cfg, frames=args.frames, noise_std=args.noise,
                      seed=args.seed, rd_impl=args.rd_impl,
                      n_integrate=n_int, range_walk=args.walk,
                      base_frames=getattr(args, "base_frames", None) or 1)
    print(json.dumps({"event": "pfa", "cfar_kind": cfg.cfar_kind,
                      **({"n_integrate": n_int} if n_int > 1 else {}),
                      **pfa}),
          flush=True)
    amps = tuple(float(a) for a in args.amplitudes.split(","))
    for pt in pd_curve(cfg, amplitudes=amps, frames=args.frames,
                       noise_std=args.noise, range_m=args.range,
                       velocity_mps=args.velocity, seed=args.seed,
                       rd_impl=args.rd_impl, n_integrate=n_int,
                       range_walk=args.walk):
        print(json.dumps({
            "event": "pd", "cfar_kind": cfg.cfar_kind,
            **({"n_integrate": n_int} if n_int > 1 else {}),
            "amplitude": pt.amplitude, "pd": round(pt.pd, 4),
            "frames": pt.frames, "mean_hits": round(pt.mean_hits, 2),
        }), flush=True)
    if args.objects:
        from mmradar.evaluate import object_metrics

        # same operating point as the Pd/Pfa metrics above: the user's
        # noise level and the strong end of the amplitude sweep; the
        # emitted record carries the full scene so nothing is implicit
        om = object_metrics(cfg, frames=args.frames, seed=args.seed,
                            rd_impl=args.rd_impl, noise_std=args.noise,
                            amplitude=max(amps))
        print(json.dumps({"event": "objects", "cfar_kind": cfg.cfar_kind,
                          **om}), flush=True)
    if args.tracks:
        from mmradar.evaluate import track_metrics

        tm = track_metrics(cfg, frames=args.frames, seed=args.seed,
                           rd_impl=args.rd_impl, noise_std=args.noise,
                           amplitude=max(amps), tracker_kind=args.tracker)
        print(json.dumps({"event": "tracks", "cfar_kind": cfg.cfar_kind,
                          **tm}), flush=True)
    return 0


def cmd_mdoppler(args) -> int:
    """Micro-Doppler spectrogram at a range gate (slow-time STFT)."""
    import json

    from mmradar.golden import micro_doppler_velocity_axis
    from mmradar.io.capture import read_capture
    from mmradar.ops.mdoppler import (
        auto_range_bin,
        micro_doppler_spectrogram,
    )

    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    if len(capture) < 2:
        print("error: capture needs a base frame + at least one frame",
              file=sys.stderr)
        return 2
    if args.win_frames < 1 or args.hop_frames < 1:
        print("error: --win-frames and --hop-frames must be >= 1",
              file=sys.stderr)
        return 2
    win_len = args.win_frames * cfg.chirps_per_tx
    if args.n_fft is not None and args.n_fft < win_len:
        print(f"error: --n-fft must be >= the window length ({win_len} "
              f"slow-time samples = {args.win_frames} frames x "
              f"{cfg.chirps_per_tx}); the STFT zero-pads, it does not "
              "truncate", file=sys.stderr)
        return 2
    if args.range_bin is not None and not (
        0 <= args.range_bin < cfg.range_fft_size
    ):
        print(f"error: --range-bin must be in [0, "
              f"{cfg.range_fft_size - 1}]", file=sys.stderr)
        return 2
    import jax.numpy as jnp

    from mmradar.ops.decode import decode_to_cube

    base_cube, k0 = _base_cube_and_start(args, capture, cfg)
    if base_cube is None:
        return 2
    frames = jnp.asarray(capture[k0:])
    r_bin = (auto_range_bin(frames, base_cube, cfg)
             if args.range_bin is None else args.range_bin)
    spec = np.asarray(micro_doppler_spectrogram(
        frames, base_cube, cfg, range_bin=r_bin,
        win_frames=args.win_frames, hop_frames=args.hop_frames,
        n_fft=args.n_fft,
    ))
    v_axis = micro_doppler_velocity_axis(spec.shape[1], cfg)
    peak_v = v_axis[np.argmax(spec, axis=1)]
    print(json.dumps({
        "event": "micro_doppler",
        "range_bin": int(r_bin),
        "windows": int(spec.shape[0]),
        "n_fft": int(spec.shape[1]),
        "win_frames": args.win_frames,
        "hop_frames": args.hop_frames,
        "velocity_resolution_mps": float(v_axis[1] - v_axis[0]),
        "peak_velocity_mps": [round(float(v), 4) for v in peak_v],
    }))
    if args.out:
        np.save(args.out, spec)
        print(f"wrote ({spec.shape[0]}, {spec.shape[1]}) spectrogram to "
              f"{args.out}", file=sys.stderr)
    if args.plot:
        from mmradar.viz import plot_micro_doppler

        plot_micro_doppler(spec, cfg, hop_frames=args.hop_frames,
                           path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
    return 0


def cmd_azmap(args) -> int:
    """Range-azimuth heatmap (every RD cell beamformed)."""
    import json

    import jax.numpy as jnp

    from mmradar.golden import angle_bin_to_deg
    from mmradar.io.capture import read_capture
    from mmradar.ops.aoa import (
        range_azimuth_capon_from_shorts,
        range_azimuth_from_shorts,
    )
    from mmradar.ops.decode import decode_to_cube

    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    if len(capture) < 2:
        print("error: capture needs a base frame + at least one frame",
              file=sys.stderr)
        return 2
    base_cube, k0 = _base_cube_and_start(args, capture, cfg)
    if base_cube is None:
        return 2
    frames = capture[k0:]
    if args.frame is not None:
        if not k0 <= args.frame < len(capture):
            print(f"error: --frame must be in [{k0}, {len(capture) - 1}]",
                  file=sys.stderr)
            return 2
        frames = capture[args.frame : args.frame + 1]
    if args.method == "capon":
        pmaps = np.asarray(range_azimuth_capon_from_shorts(
            jnp.asarray(frames), base_cube, cfg))
        lo, hi, na = cfg.angle_grid_deg
        deg_of = np.linspace(lo, hi, int(na))
    else:
        pmaps = np.asarray(range_azimuth_from_shorts(
            jnp.asarray(frames), base_cube, cfg))
        deg_of = None
    pmap = pmaps.mean(axis=0)     # noncoherent integration over frames
    a_bin, r_bin = np.unravel_index(np.argmax(pmap), pmap.shape)
    peak_az = (float(deg_of[a_bin]) if deg_of is not None
               else float(angle_bin_to_deg(a_bin, pmap.shape[0], cfg)))
    print(json.dumps({
        "event": "range_azimuth",
        "method": args.method,
        "frames": int(pmaps.shape[0]),
        "angle_bins": int(pmap.shape[0]),
        "range_bins": int(pmap.shape[1]),
        "peak_azimuth_deg": round(peak_az, 3),
        "peak_range_bin": int(r_bin),
    }))
    if args.out:
        np.save(args.out, pmap)
        print(f"wrote {pmap.shape} range-azimuth map to {args.out}",
              file=sys.stderr)
    if args.plot:
        from mmradar.viz import plot_range_azimuth

        plot_range_azimuth(pmap, cfg, path=args.plot, angles_deg=deg_of)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
    return 0


def cmd_bev(args) -> int:
    """World-frame bird's-eye view from a moving platform: detect, fit
    the ego velocity per frame, dead-reckon the platform pose, and
    accumulate every detection in WORLD coordinates — static scatterers
    observed from different positions collapse onto the same world
    cells, movers trace their paths.  Heading is held fixed (yaw rate is
    unobservable from one radar's Doppler; see
    ``utils.points.world_points``)."""
    import json

    import jax
    import jax.numpy as jnp

    from mmradar.io.capture import read_capture
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.ops.egomotion import (
        ego_compensated_velocity,
        estimate_ego_motion,
    )
    from mmradar.utils.points import detections_to_xyz, world_points

    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    if len(capture) < 3:
        print("error: bev needs a base frame + at least two frames",
              file=sys.stderr)
        return 2
    second = getattr(args, "second", None)
    if second and not getattr(args, "mount2", None):
        print("error: --second needs --mount2 (the second radar's body "
              "pose)", file=sys.stderr)
        return 2

    def parse_mount(txt):
        parts = [float(v) for v in txt.split(",")]
        if len(parts) != 3:
            raise ValueError(f"mount needs x,y,yaw_deg, got {txt!r}")
        return tuple(parts)

    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl)
    k0 = getattr(args, "base_frames", None) or 1
    if k0 >= len(capture) - 1:
        print(f"error: --base-frames {k0} leaves fewer than two frames",
              file=sys.stderr)
        return 2
    base = pipe.prepare_base(capture[0] if k0 == 1 else capture[:k0])
    rd = jax.tree.map(np.asarray, pipe.detect(capture[k0:], base))
    em = jax.tree.map(np.asarray, estimate_ego_motion(
        jnp.asarray(rd.azimuth_deg), jnp.asarray(rd.velocity_mps),
        jnp.asarray(rd.valid), inlier_mps=args.ego,
    ))
    vg = np.asarray(ego_compensated_velocity(
        jnp.asarray(rd.azimuth_deg), jnp.asarray(rd.velocity_mps),
        jnp.asarray(em.velocity)))
    valid = rd.valid
    fi, ki = np.nonzero(valid)
    x, y, _ = detections_to_xyz(rd.range_m_interp[fi, ki],
                                rd.azimuth_deg[fi, ki])
    dt = cfg.num_chirps * cfg.chirp_interval_s
    st = em.is_static[fi, ki]
    yaw_rec = {}
    if second:
        # two-radar yaw-rate fit: per-frame per-sensor ego fits combine
        # into the rigid-body (vx, vy, omega); heading integrates into
        # the dead reckoning (utils.points.world_points_yaw)
        from mmradar import golden as _golden
        from mmradar.utils.points import world_points_yaw

        mount1 = parse_mount(args.mount)
        mount2 = parse_mount(args.mount2)
        cap2 = read_capture(second, cfg)
        if len(cap2) < 3:
            print("error: --second needs a base frame + at least two "
                  "frames", file=sys.stderr)
            return 2
        n = min(len(capture), len(cap2))
        rd2 = jax.tree.map(np.asarray,
                           pipe.detect(cap2[1:n],
                                       pipe.prepare_base(cap2[0])))
        em2 = jax.tree.map(np.asarray, estimate_ego_motion(
            jnp.asarray(rd2.azimuth_deg), jnp.asarray(rd2.velocity_mps),
            jnp.asarray(rd2.valid), inlier_mps=args.ego,
        ))
        n_f = min(em.velocity.shape[0], em2.velocity.shape[0])
        v_body = np.zeros((n_f, 2))
        omega = np.zeros(n_f)
        ok_j = np.zeros(n_f, bool)
        for f in range(n_f):
            if em.ok[f] and em2.ok[f]:
                vb, om, okf = _golden.estimate_ego_motion_yaw(
                    [em.velocity[f], em2.velocity[f]], [mount1, mount2]
                )
                v_body[f], omega[f], ok_j[f] = vb, om, okf
        keep = fi < n_f
        fi, ki, x, y, st = fi[keep], ki[keep], x[keep], y[keep], st[keep]
        xw, yw, pose, head = world_points_yaw(
            fi, x, y, v_body, omega, ok_j, dt, mount1)
        # the second radar's detections join the world picture too
        fi2, ki2 = np.nonzero(rd2.valid)
        keep2 = fi2 < n_f
        fi2, ki2 = fi2[keep2], ki2[keep2]
        x2, y2, _ = detections_to_xyz(rd2.range_m_interp[fi2, ki2],
                                      rd2.azimuth_deg[fi2, ki2])
        xw2, yw2, _, _ = world_points_yaw(
            fi2, x2, y2, v_body, omega, ok_j, dt, mount2)
        vg2 = np.asarray(ego_compensated_velocity(
            jnp.asarray(rd2.azimuth_deg), jnp.asarray(rd2.velocity_mps),
            jnp.asarray(em2.velocity)))
        st2 = em2.is_static[fi2, ki2]
        xw = np.concatenate([xw, xw2])
        yw = np.concatenate([yw, yw2])
        st = np.concatenate([st, st2])
        vg_pts = np.concatenate([vg[fi, ki], vg2[fi2, ki2]])
        fi_all = np.concatenate([fi, fi2])
        n_ok = int(ok_j.sum())
        yaw_rec = {
            "yaw_fit_ok_frames": n_ok,
            "mean_yaw_rate_dps": round(float(
                np.rad2deg(omega[ok_j].mean())) if n_ok else 0.0, 3),
            "heading_total_deg": round(float(head[-1]), 3),
        }
    else:
        xw, yw, pose = world_points(fi, x, y, em.velocity, em.ok, dt)
        vg_pts = vg[fi, ki]
        fi_all = fi
        n_ok = int(em.ok.sum())
    print(json.dumps({
        "event": "bev",
        "frames": int(valid.shape[0]),
        "ego_fit_ok_frames": n_ok,
        "points": int(len(xw)),
        "static_points": int(st.sum()),
        "mover_points": int(len(xw) - st.sum()),
        "platform_distance_m": round(float(
            np.linalg.norm(pose[-1] - pose[0])), 3),
        **yaw_rec,
    }))
    if args.out:
        with open(args.out, "w") as f:
            f.write("frame,x_world_m,y_world_m,is_static,"
                    "velocity_ground_mps\n")
            for i in range(len(xw)):
                f.write(f"{int(fi_all[i])},{xw[i]:.4f},{yw[i]:.4f},"
                        f"{int(st[i])},{vg_pts[i]:.4f}\n")
        print(f"wrote {len(xw)} world points to {args.out}",
              file=sys.stderr)
    if args.plot:
        from mmradar.viz import plot_bev

        plot_bev(xw, yw, st, vg_pts, pose, cfg, path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    """Derived system parameters for a configuration — the numbers a
    radar engineer reaches for first (resolutions, unambiguous spans,
    data rates).  The reference never prints these; they are scattered
    through its #defines (acceleration.cu:7-15)."""
    import json

    cfg = _build_cfg(args)
    c = LIGHT_SPEED
    r_res = (cfg.sample_rate_hz / cfg.range_fft_size) * c / (
        2.0 * cfg.slope_hz_per_s)
    ts = cfg.slow_time_interval_s
    v_max = cfg.wavelength_m / (4.0 * ts)
    v_res = cfg.wavelength_m / (2.0 * cfg.doppler_fft_size * ts)
    cpi_s = cfg.num_chirps * cfg.chirp_interval_s
    # 3-dB beamwidth of an N-element half-wavelength ULA ~ 102/N deg
    n_v = cfg.num_virtual_rx
    doc = {
        "waveform": {
            "carrier_ghz": cfg.carrier_hz / 1e9,
            "slope_mhz_per_us": cfg.slope_hz_per_s / 1e12,
            "sample_rate_mhz": cfg.sample_rate_hz / 1e6,
            "chirp_interval_us": cfg.chirp_interval_s * 1e6,
            "samples_per_chirp": cfg.num_samples,
            "chirps_per_frame": cfg.num_chirps,
            "cpi_ms": round(cpi_s * 1e3, 3),
            "frame_rate_hz_max": round(1.0 / cpi_s, 1),
        },
        "array": {
            "num_tx": cfg.num_tx,
            "num_rx": cfg.num_rx,
            "virtual_elements": n_v,
            "approx_beamwidth_deg": round(102.0 / n_v, 1),
            "angle_bins": cfg.num_angle_bins,
        },
        "range": {
            "resolution_m": round(r_res, 4),
            "max_m": round(r_res * cfg.range_fft_size, 2),
            "fft_size": cfg.range_fft_size,
            "parity_scan_max_m": round(cfg.max_range_m, 2),
        },
        "velocity": {
            "resolution_mps": round(v_res, 4),
            "unambiguous_span_mps": [round(-v_max, 3), round(v_max, 3)],
            "tdm_note": (None if cfg.num_tx == 1 else
                         "span divided by num_tx under TDM; "
                         "--disambiguate recovers the full span"),
            "fft_size": cfg.doppler_fft_size,
        },
        "data": {
            "bytes_per_frame": cfg.bytes_per_frame,
            "mb_per_s_at_1000fps": round(cfg.bytes_per_frame * 1e3 / 1e6, 1),
        },
        "detector": {
            "cfar_kind": cfg.cfar_kind,
            "cfar_pfa": cfg.cfar_pfa,
            # the round-5 calibrated operating point: the alpha models
            # the RX-summed map's Erlang order, so the realized Pfa
            # lands on cfar_pfa (MIGRATION round-5 notes)
            "cfar_pulses_effective": cfg.cfar_pulses_effective,
            "range_edge_guard_bins": cfg.range_edge_guard_effective,
            "detectable_range_max_m": round(
                (cfg.range_fft_size - cfg.range_edge_guard_effective - 1)
                * r_res, 2),
        },
    }
    print(json.dumps(doc, indent=1))
    return 0


def cmd_rti(args) -> int:
    """Range-time intensity (RTI) waterfall: per-frame range power
    (Doppler-integrated), frames x range — the classic scrolling view
    of how the scene evolves."""
    import json

    import jax.numpy as jnp

    import jax

    from mmradar.io.capture import read_capture
    from mmradar.ops.decode import decode_to_cube
    from mmradar.ops.fuseddft import fused_rd_planes

    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    if len(capture) < 2:
        print("error: capture needs a base frame + at least one frame",
              file=sys.stderr)
        return 2
    base, k0 = _base_cube_and_start(args, capture, cfg)
    if base is None:
        return 2

    @jax.jit
    def rti(shorts, base_cube):
        dr, di = fused_rd_planes(shorts, base_cube, cfg)
        return (dr * dr + di * di).sum(axis=(-3, -2))  # (B, R)

    m = np.asarray(rti(jnp.asarray(capture[k0:]), base))
    r_bin = int(np.unravel_index(np.argmax(m), m.shape)[1])
    print(json.dumps({
        "event": "rti",
        "frames": int(m.shape[0]),
        "range_bins": int(m.shape[1]),
        "peak_range_bin": r_bin,
        "peak_range_m": round(r_bin * (cfg.sample_rate_hz
                              / cfg.range_fft_size) * LIGHT_SPEED
                              / (2.0 * cfg.slope_hz_per_s), 3),
    }))
    if args.out:
        np.save(args.out, m)
        print(f"wrote {m.shape} RTI matrix to {args.out}", file=sys.stderr)
    if args.plot:
        from mmradar.viz import plot_rti

        plot_rti(m, cfg, path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
    return 0


def cmd_admap(args) -> int:
    """Angle-Doppler heatmap at a range gate (movers separate by
    velocity AND bearing)."""
    import json

    import jax.numpy as jnp

    from mmradar.golden import angle_bin_to_deg
    from mmradar.io.capture import read_capture
    from mmradar.ops.aoa import angle_doppler_from_shorts
    from mmradar.ops.decode import decode_to_cube
    from mmradar.ops.mdoppler import auto_range_bin

    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    if len(capture) < 2:
        print("error: capture needs a base frame + at least one frame",
              file=sys.stderr)
        return 2
    base_cube, k0 = _base_cube_and_start(args, capture, cfg)
    if base_cube is None:
        return 2
    frames = capture[k0:]
    if args.frame is not None:
        if not k0 <= args.frame < len(capture):
            print(f"error: --frame must be in [{k0}, {len(capture) - 1}]",
                  file=sys.stderr)
            return 2
        frames = capture[args.frame : args.frame + 1]
    gate = args.range_bin
    if gate is None:
        gate = auto_range_bin(jnp.asarray(frames), base_cube, cfg)
    elif not 0 <= gate < cfg.range_fft_size:
        print(f"error: --range-bin must be in [0, {cfg.range_fft_size})",
              file=sys.stderr)
        return 2
    pmaps = np.asarray(angle_doppler_from_shorts(
        jnp.asarray(frames), base_cube, cfg, range_bin=int(gate)))
    pmap = pmaps.mean(axis=0)     # noncoherent integration over frames
    d_bin, a_bin = np.unravel_index(np.argmax(pmap), pmap.shape)
    d = cfg.doppler_fft_size
    peak_v = ((int(d_bin) - d // 2) / (d * cfg.slow_time_interval_s)
              * cfg.wavelength_m / 2.0)
    print(json.dumps({
        "event": "angle_doppler",
        "range_bin": int(gate),
        "range_m": round(float(gate) * (cfg.sample_rate_hz
                         / cfg.range_fft_size) * LIGHT_SPEED
                         / (2.0 * cfg.slope_hz_per_s), 3),
        "frames": int(pmaps.shape[0]),
        "doppler_bins": int(pmap.shape[0]),
        "angle_bins": int(pmap.shape[1]),
        "peak_velocity_mps": round(float(peak_v), 4),
        "peak_azimuth_deg": round(
            float(angle_bin_to_deg(a_bin, pmap.shape[1], cfg)), 3),
    }))
    if args.out:
        np.save(args.out, pmap)
        print(f"wrote {pmap.shape} angle-doppler map to {args.out}",
              file=sys.stderr)
    if args.plot:
        from mmradar.viz import plot_angle_doppler

        plot_angle_doppler(pmap, cfg, path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
    return 0


def cmd_verify(args) -> int:
    """Device pipeline vs float64 golden, frame by frame — the promoted
    version of the reference's disabled verification loop
    (cudaBenchMarking.cpp:410-419)."""
    import jax

    from mmradar import golden
    from mmradar.io.capture import read_capture
    from mmradar.models.range_detector import RangeDetector

    cfg = RadarConfig()
    capture = read_capture(args.path, cfg)
    det = RangeDetector(cfg)
    got = jax.tree.map(np.asarray, det.detect_capture(capture))
    want = golden.detect_capture(capture, cfg)

    failures = 0
    for i, w in enumerate(want):
        bin_ok = int(got.peak_bin[i]) == w.peak_bin
        dis_ok = abs(float(got.distance_m[i]) - w.distance_m) <= max(
            1e-3 * w.distance_m, 1e-9
        )
        mag_ok = (
            abs(float(got.peak_magnitude[i]) - w.peak_magnitude)
            <= 1e-3 * max(w.peak_magnitude, 1e-30)
        )
        if not (bin_ok and dis_ok and mag_ok):
            failures += 1
            print(
                f"FRAME {i+1} MISMATCH: device bin {int(got.peak_bin[i])} "
                f"dis {float(got.distance_m[i]):.6f} mag "
                f"{float(got.peak_magnitude[i]):.3f} vs golden "
                f"{w.peak_bin}/{w.distance_m:.6f}/{w.peak_magnitude:.3f}"
            )
    n = len(want)
    print(f"verified {n} frames: {n - failures} ok, {failures} failed")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mmradar")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a synthetic ADC capture")
    g.add_argument("path")
    g.add_argument("--frames", type=int, default=90)
    g.add_argument(
        "--target", action="append", default=[],
        help="range_m,vel_mps,azimuth_deg[,amplitude[,elevation_deg]] "
             "(repeatable; elevation needs --elevated-tx)",
    )
    g.add_argument("--noise", type=float, default=10.0)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--base-frames", type=int, default=None, metavar="K",
                   help="emit K empty-scene base frames before the "
                        "target frames (default 1; pair with detect/"
                        "track/serve --base-frames K)")
    g.add_argument("--interference", type=int, default=0,
                   help="mutual-FMCW interference bursts per frame "
                        "(strong broadband mini-chirps; see "
                        "detect --blank-interference)")
    g.add_argument("--num-tx", type=int, default=None,
                   help="TDM-MIMO transmitters in the synthesized waveform")
    g.add_argument("--elevated-tx", type=float, default=None, nargs="?",
                   const=0.5, metavar="WL",
                   help="raise the last TX by WL wavelengths so targets "
                        "may carry a nonzero elevation")
    g.add_argument("--platform", default=None, metavar="VX,VY",
                   help="platform (ego) velocity in m/s: world-fixed "
                        "targets (--world-target) evolve range/azimuth/"
                        "Doppler from the true geometry")
    g.add_argument("--world-target", action="append", default=None,
                   metavar="X,Y[,AMP]",
                   help="WORLD-fixed scatterer at (x right, y boresight) "
                        "meters; repeatable (pairs with --platform)")
    g.add_argument("--chirps", type=int, default=None,
                   help="chirps per frame in the synthesized waveform")
    g.add_argument("--slope", type=float, default=None, metavar="MHZ_US",
                   help="chirp slope in MHz/us")
    g.add_argument("--chirp-motion", action="store_true",
                   help="evolve each target's range per CHIRP (physically "
                        "honest intra-CPI motion: the range peak walks "
                        "v*CPI/r_res cells across the CPI — what "
                        "detect --keystone compensates); default keeps "
                        "range fixed within a frame")
    g.add_argument("--rx-imbalance", default=None, metavar="G:DEG,...",
                   help="per-RX hardware channel response as "
                        "gain:phase_deg pairs (one per RX, e.g. "
                        "'1:0,1.2:35,0.8:-40,1.1:-18') — the imperfection "
                        "`calibrate` measures and `--cal` undoes")
    g.set_defaults(fn=cmd_generate)

    c = sub.add_parser(
        "calibrate",
        help="estimate per-channel gain/phase correction from a capture "
             "of one reflector at a known angle (float64 golden path); "
             "apply with --cal on detect/track/serve/azmap",
    )
    c.add_argument("path", help="calibration capture (frame 0 = empty "
                                "scene, then the boresight reflector)")
    c.add_argument("--az", type=float, default=0.0,
                   help="reflector's true azimuth in degrees (default 0 "
                        "= boresight)")
    c.add_argument("--el", type=float, default=0.0,
                   help="reflector's true elevation in degrees")
    c.add_argument("--frames", type=int, default=None,
                   help="use at most this many target frames")
    c.add_argument("--out", default=None, help="output path (cal.json)")
    c.add_argument("--num-tx", type=int, default=None)
    c.add_argument("--elevated-tx", type=float, default=None, nargs="?",
                   const=0.5, metavar="WL")
    c.add_argument("--window-kind", default=None,
                   choices=["hann", "hamming", "blackman",
                            "blackmanharris", "rect"])
    c.set_defaults(fn=cmd_calibrate)

    d = sub.add_parser("detect", help="run detection, write JSONL records")
    d.add_argument("path")
    d.add_argument("--out", default=None)
    d.add_argument("--full", action="store_true",
                   help="include range-Doppler-CFAR-AoA detections")
    d.add_argument("--max-detections", type=int, default=16)
    d.add_argument("--resume", action="store_true",
                   help="append records after the last frame already in --out")
    d.add_argument("--cluster", action="store_true",
                   help="with --full: group CFAR hit blobs into objects "
                        "and attach cluster id/centroid/extent per "
                        "detection")
    d.add_argument("--keystone", action="store_true",
                   help="with --full: keystone range-migration "
                        "compensation — rescale slow time per fast-time "
                        "sample before the FFTs so intra-CPI range walk "
                        "vanishes (long-CPI / fine-range-resolution "
                        "configs; unambiguous velocities); forces the "
                        "complex-cube front-end (rd_impl fft/mxu)")
    d.add_argument("--disambiguate", action="store_true",
                   help="with --full on a TDM-MIMO config (num_tx > 1): "
                        "recover velocities over the full single-TX span "
                        "via the TDM phase-hypothesis test; replaces "
                        "velocity_mps/azimuth_deg and records the winning "
                        "doppler_hypothesis per detection")
    d.add_argument("--points", default=None, metavar="PATH",
                   help="with --full: also write a Cartesian point cloud "
                        "(one point per detection; CSV, or ASCII PLY for "
                        "a .ply path)")
    d.add_argument("--points-plot", default=None, metavar="PNG",
                   help="with --full: top-down point-cloud scatter "
                        "colored by radial velocity")
    d.add_argument("--integrate", type=int, default=None, metavar="N",
                   help="with --full: non-coherent integration — sum N "
                        "consecutive frames' RD power maps before CFAR "
                        "(one record per group, frame = the group's last; "
                        "the low-SNR Pd lever)")
    d.add_argument("--cmap", type=float, default=None, nargs="?",
                   const=0.25, metavar="BETA",
                   help="with --full: clutter-map detector instead of "
                        "spatial CFAR — per-cell recursive background "
                        "updated once per block of frames (exact under "
                        "spatially varying clutter floors; the first "
                        "block warms up; optional value = update weight "
                        "beta, default 0.25)")
    d.add_argument("--cmap-block", type=int, default=16, metavar="B",
                   help="frames per clutter-map update (default 16): "
                        "choose >= the slowest target's cell dwell or "
                        "the map absorbs movers (measured: a 3 m/s "
                        "target vanished after ONE frame under per-frame "
                        "updates)")
    d.add_argument("--walk", action="store_true",
                   help="with --integrate: Doppler-conditioned range-walk "
                        "alignment before the sum (fast targets keep "
                        "integrating past one range cell per group)")
    d.add_argument("--ego", type=float, default=None, nargs="?",
                   const=0.5, metavar="INLIER_MPS",
                   help="with --full: fit the platform (ego) velocity per "
                        "frame from the static-scatterer Doppler-azimuth "
                        "sinusoid; records ego {vx, vy, ok, n_static} per "
                        "frame and is_static / velocity_ground_mps per "
                        "detection (optional value = inlier gate in m/s, "
                        "default 0.5)")
    _add_blank_flag(d)
    _add_pipeline_flags(d)
    _add_refine_flag(d)
    d.set_defaults(fn=cmd_detect)

    s = sub.add_parser("serve", help="live UDP stream -> JSONL detections")
    s.add_argument("--port", type=int, required=True, action="append",
                   help="UDP port (repeat for multiple DCA1000 sources; "
                        "each source gets its own base frame and tracker)")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--max-frames", type=int, default=-1,
                   help="stop after N frames (default: run until timeout)")
    s.add_argument("--timeout", type=float, default=5.0,
                   help="socket timeout in seconds")
    s.add_argument("--confirm-hits", type=int, default=None, metavar="M",
                    help="tracker M-hit confirmation (default 3; round-5 "
                         "bump from 2 -- see MIGRATION)")
    s.add_argument("--max-misses", type=int, default=None, metavar="N",
                    help="coasted misses before a track is dropped "
                         "(default 3)")
    s.add_argument("--tracker", choices=["alpha-beta", "ekf"],
                   default="alpha-beta")
    s.add_argument("--serve-batch", type=int, default=8,
                   help="max frames per detection dispatch (frames already "
                        "received batch together with zero added wait)")
    s.add_argument("--max-detections", type=int, default=16)
    s.add_argument("--ego", type=float, default=None, nargs="?",
                   const=0.5, metavar="INLIER_MPS",
                   help="moving-platform serving: fit the ego velocity "
                        "per frame (host-side, zero device cost), label "
                        "detections static/moving with ground-frame "
                        "velocities, and track movers only")
    s.add_argument("--cmap", type=float, default=None, nargs="?",
                   const=0.25, metavar="BETA",
                   help="clutter-map detector instead of spatial CFAR: "
                        "per-cell recursive background carried across "
                        "micro-batches per source (first served frame "
                        "warms up)")
    s.add_argument("--disambiguate", action="store_true",
                   help="TDM phase-hypothesis velocity disambiguation per "
                        "batch (num_tx > 1): served velocities cover the "
                        "full single-TX span")
    s.add_argument("--integrate", type=int, default=None, metavar="N",
                   help="live non-coherent integration: detect on the sum "
                        "of N consecutive frames' RD power maps per source "
                        "(integration-matched CFAR alpha; one record per "
                        "group; group alignment is fixed by arrival order "
                        "across micro-batches; pair with --clutter mean "
                        "or mti2)")
    s.add_argument("--walk", action="store_true",
                   help="with --integrate: Doppler-conditioned range-walk "
                        "alignment before the sum (fast targets keep "
                        "integrating past one cell per group)")
    _add_blank_flag(s)
    _add_pipeline_flags(s)
    _add_refine_flag(s)
    s.set_defaults(fn=cmd_serve)

    r = sub.add_parser("replay",
                       help="stream a capture file as DCA1000 UDP packets "
                            "(the sensor side of `serve`)")
    r.add_argument("path")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, required=True)
    r.add_argument("--fps", type=float, default=100.0,
                   help="frame pacing (0 = as fast as possible)")
    r.add_argument("--max-frames", type=int, default=-1)
    r.set_defaults(fn=cmd_replay)

    t = sub.add_parser("track", help="detect + multi-frame object tracking")
    t.add_argument("path")
    t.add_argument("--max-detections", type=int, default=16)
    t.add_argument("--confirm-hits", type=int, default=None, metavar="M",
                    help="tracker M-hit confirmation (default 3; round-5 "
                         "bump from 2 -- see MIGRATION)")
    t.add_argument("--max-misses", type=int, default=None, metavar="N",
                    help="coasted misses before a track is dropped "
                         "(default 3)")
    t.add_argument("--tracker", choices=["alpha-beta", "ekf"],
                   default="alpha-beta",
                   help="'ekf' = Cartesian constant-velocity EKF "
                        "(tracks crossing targets)")
    t.add_argument("--cluster", action="store_true",
                   help="feed one measurement per hit-blob object "
                        "(suppress same-cluster duplicates before "
                        "tracking)")
    t.add_argument("--ego", type=float, default=None, nargs="?",
                   const=0.5, metavar="INLIER_MPS",
                   help="moving-platform tracking: fit the ego velocity "
                        "per frame, drop static-world detections before "
                        "tracking, and report each track's ground-frame "
                        "radial velocity (optional value = inlier gate "
                        "in m/s, default 0.5)")
    t.add_argument("--disambiguate", action="store_true",
                   help="TDM phase-hypothesis velocity disambiguation "
                        "before tracking (num_tx > 1): track states get "
                        "true velocities past the TDM limit")
    t.add_argument("--out", default=None, metavar="TRACKS.jsonl",
                   help="also write one JSONL record per confirmed "
                        "track, including its full (range, velocity, "
                        "azimuth) state history")
    t.add_argument("--plot", default=None, metavar="PNG",
                   help="range-vs-time trajectory plot of the confirmed "
                        "tracks")
    _add_blank_flag(t)
    _add_pipeline_flags(t)
    _add_refine_flag(t)
    t.set_defaults(fn=cmd_track)

    b = sub.add_parser("bench", help="benchmark over a capture file")
    b.add_argument("path")
    b.add_argument("--native", action="store_true",
                   help="run the native C++ golden model instead of the "
                        "device pipeline")
    b.add_argument("--full", action="store_true")
    b.add_argument("--batch", type=int, default=64)
    b.add_argument("--max-detections", type=int, default=16)
    b.add_argument("--stages", action="store_true",
                   help="print the reference-format 4-bucket stage breakdown")
    b.add_argument("--compare", action="store_true",
                   help="one-shot native-golden + device run on the same "
                        "capture with the per-frame verification loop "
                        "enabled (the reference main() with "
                        "cudaBenchMarking.cpp:410-419 un-commented); exit "
                        "code reflects the gate")
    b.add_argument("--per-frame", action="store_true",
                   help="with --compare: print one line per frame "
                        "(native/device distance + inner ms, the always-on "
                        "per-frame line at acceleration.cu:533)")
    b.add_argument("--profile", default=None, metavar="DIR",
                   help="export a jax.profiler trace to DIR")
    b.add_argument("--latency", action="store_true",
                   help="report dispatch->result latency percentiles "
                        "(p50/p90/p99) for the serving program")
    _add_pipeline_flags(b)
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser(
        "eval",
        help="Pd/Pfa detection-performance evaluation (synthetic scenes)",
    )
    _add_pipeline_flags(e)
    e.add_argument("--frames", type=int, default=32,
                   help="frames per measurement point")
    e.add_argument("--amplitudes", default="20,40,80,160,320",
                   help="comma-separated target amplitudes for the Pd curve")
    e.add_argument("--noise", type=float, default=20.0)
    e.add_argument("--range", type=float, default=6.0,
                   help="target range (m)")
    e.add_argument("--velocity", type=float, default=2.0,
                   help="target velocity (m/s)")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--integrate", type=int, default=None, metavar="N",
                   help="non-coherent integration depth for the Pfa/Pd "
                        "metrics (one decision per N-frame group)")
    e.add_argument("--walk", action="store_true",
                   help="with --integrate: range-walk alignment before "
                        "the sum")
    e.add_argument("--objects", action="store_true",
                   help="also score the object level: clustered "
                        "representatives matched to the true targets "
                        "(count, Pd, centroid RMSE)")
    e.add_argument("--tracks", action="store_true",
                   help="also score the track level: the tracker against "
                        "analytic moving-target trajectories (track Pd, "
                        "ID switches, fragmentation, state RMSE)")
    e.add_argument("--tracker", choices=["ekf", "alpha-beta"], default="ekf",
                   help="tracker kind for --tracks")
    e.set_defaults(fn=cmd_eval)

    v = sub.add_parser("verify", help="device vs float64 golden, per frame")
    v.add_argument("path")
    v.set_defaults(fn=cmd_verify)

    md = sub.add_parser(
        "mdoppler",
        help="micro-Doppler spectrogram at a range gate (slow-time STFT "
             "across frames; .npy out + PNG plot)",
    )
    md.add_argument("path")
    md.add_argument("--base-frames", type=int, default=None, metavar="K",
                    help="average the first K empty-scene frames into "
                         "the base (quenched-noise floor / K)")
    md.add_argument("--range-bin", type=int, default=None,
                    help="range gate (default: strongest bin over the "
                         "capture)")
    md.add_argument("--win-frames", type=int, default=8,
                    help="STFT window length in frames (default 8)")
    md.add_argument("--hop-frames", type=int, default=1,
                    help="STFT hop in frames (default 1)")
    md.add_argument("--n-fft", type=int, default=None,
                    help="STFT size (default: window length)")
    md.add_argument("--out", default=None,
                    help="write the (windows, n_fft) power array as .npy")
    md.add_argument("--plot", default=None,
                    help="write a time x velocity PNG")
    md.add_argument("--dft-precision", default=None,
                    choices=["high", "highest", "default"])
    md.add_argument("--clutter", default=None,
                    choices=["auto", "base", "mean", "mti2", "mti3"])
    md.add_argument("--window-kind", default=None,
                    choices=["hann", "hamming", "blackman",
                             "blackmanharris", "rect"])
    md.set_defaults(fn=cmd_mdoppler)

    az = sub.add_parser(
        "azmap",
        help="range-azimuth heatmap: every RD cell beamformed over the "
             "virtual array, Doppler-integrated (.npy out + PNG plot)",
    )
    az.add_argument("path")
    az.add_argument("--base-frames", type=int, default=None, metavar="K",
                    help="average the first K empty-scene frames into "
                         "the base (quenched-noise floor / K)")
    az.add_argument("--frame", type=int, default=None,
                    help="single capture frame (default: average over "
                         "all frames)")
    az.add_argument("--method", default="fft", choices=["fft", "capon"],
                    help="beamformer: zero-padded angle FFT (fast) or "
                         "Capon/MVDR per range bin (sharper beams)")
    az.add_argument("--out", default=None,
                    help="write the (angle_bins, range_fft) map as .npy")
    az.add_argument("--plot", default=None,
                    help="write a range x azimuth PNG")
    az.add_argument("--num-tx", type=int, default=None,
                    help="TDM-MIMO TX count")
    az.add_argument("--cal", default=None, metavar="CAL.json",
                    help="apply per-channel calibration corrections")
    az.add_argument("--elevated-tx", type=float, default=None, nargs="?",
                    const=0.5, metavar="WL",
                    help="raise the last TX by WL wavelengths (planar "
                         "virtual array)")
    az.add_argument("--dft-precision", default=None,
                    choices=["high", "highest", "default"])
    az.add_argument("--clutter", default=None,
                    choices=["auto", "base", "mean", "mti2", "mti3"])
    az.add_argument("--window-kind", default=None,
                    choices=["hann", "hamming", "blackman",
                             "blackmanharris", "rect"])
    az.set_defaults(fn=cmd_azmap)

    ad = sub.add_parser(
        "admap",
        help="angle-Doppler heatmap at a range gate (movers separate by "
             "velocity AND bearing; .npy out + PNG plot)",
    )
    ad.add_argument("path")
    ad.add_argument("--base-frames", type=int, default=None, metavar="K",
                    help="average the first K empty-scene frames into "
                         "the base (quenched-noise floor / K)")
    ad.add_argument("--frame", type=int, default=None,
                    help="single capture frame (default: average over "
                         "all frames)")
    ad.add_argument("--range-bin", type=int, default=None,
                    help="range gate (default: strongest bin over the "
                         "capture)")
    ad.add_argument("--out", default=None,
                    help="write the (doppler_fft, angle_bins) map as .npy")
    ad.add_argument("--plot", default=None,
                    help="write an azimuth x velocity PNG")
    ad.add_argument("--num-tx", type=int, default=None,
                    help="TDM-MIMO TX count")
    ad.add_argument("--cal", default=None, metavar="CAL.json",
                    help="apply per-channel calibration corrections")
    ad.add_argument("--dft-precision", default=None,
                    choices=["high", "highest", "default"])
    ad.add_argument("--clutter", default=None,
                    choices=["auto", "base", "mean", "mti2", "mti3"])
    ad.add_argument("--window-kind", default=None,
                    choices=["hann", "hamming", "blackman",
                             "blackmanharris", "rect"])
    ad.set_defaults(fn=cmd_admap)

    inf = sub.add_parser(
        "info",
        help="derived system parameters (resolutions, unambiguous "
             "spans, CPI, data rates) for a configuration",
    )
    inf.add_argument("--num-tx", type=int, default=None)
    inf.add_argument("--elevated-tx", type=float, default=None, nargs="?",
                     const=0.5, metavar="WL")
    inf.set_defaults(fn=cmd_info)

    bv = sub.add_parser(
        "bev",
        help="world-frame bird's-eye view from a moving platform: "
             "ego-motion dead reckoning + accumulated detections "
             "(CSV out + PNG plot)",
    )
    bv.add_argument("path")
    bv.add_argument("--ego", type=float, default=0.5, metavar="INLIER_MPS",
                    help="ego-fit inlier gate in m/s (default 0.5)")
    bv.add_argument("--max-detections", type=int, default=16)
    bv.add_argument("--out", default=None,
                    help="write world points as CSV")
    bv.add_argument("--plot", default=None, help="write a PNG BEV")
    bv.add_argument("--second", default=None, metavar="CAP2",
                    help="second radar's capture (synchronized frames): "
                         "enables the two-radar yaw-rate fit — heading "
                         "becomes observable and the dead reckoning "
                         "integrates it (golden.estimate_ego_motion_yaw)")
    bv.add_argument("--mount", default="0,0,0", metavar="X,Y,YAW",
                    help="first radar's body pose: x right (m), y "
                         "forward (m), boresight yaw (deg, positive "
                         "toward +x); default 0,0,0")
    bv.add_argument("--mount2", default=None, metavar="X,Y,YAW",
                    help="second radar's body pose (required with "
                         "--second; must differ in position from "
                         "--mount for yaw observability)")
    _add_pipeline_flags(bv)
    bv.set_defaults(fn=cmd_bev)

    rt = sub.add_parser(
        "rti",
        help="range-time intensity waterfall (per-frame range power, "
             "Doppler-integrated; .npy out + PNG plot)",
    )
    rt.add_argument("path")
    rt.add_argument("--base-frames", type=int, default=None, metavar="K",
                    help="average the first K empty-scene frames into "
                         "the base (quenched-noise floor / K)")
    rt.add_argument("--out", default=None,
                    help="write the (frames, range_fft) matrix as .npy")
    rt.add_argument("--plot", default=None, help="write a PNG waterfall")
    rt.add_argument("--num-tx", type=int, default=None)
    rt.add_argument("--clutter", default=None,
                    choices=["auto", "base", "mean", "mti2", "mti3", "none"])
    rt.add_argument("--window-kind", default=None,
                    choices=["hann", "hamming", "blackman",
                             "blackmanharris", "rect"])
    rt.set_defaults(fn=cmd_rti)

    args = ap.parse_args(argv)
    from mmradar.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
