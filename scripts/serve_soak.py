#!/usr/bin/env python
"""Serve-loopback soak: prove the live path end-to-end, with an artifact.

Serve emits latency percentiles; this script shows the real-time story
end to end through the live UDP path:

  1. synthesizes a capture (2 targets + noise),
  2. starts ``cli serve`` as a subprocess on a loopback port,
  3. waits for its ``{"event": "ready"}`` line (pipeline compiled),
  4. replays the capture as DCA1000-style UDP datagrams at ``--fps``,
  5. collects the per-frame JSONL records and the shutdown
     ``latency_stats`` event,
  6. writes a summary JSON (sustained fps, offered fps, delivery rate,
     p50/p90/p99 ingest->record) to ``--out``.

``serve`` is the only process that touches the device (``replay`` never
initializes a JAX backend), so one card serves one JAX process.

Usage: python scripts/serve_soak.py [--frames 400] [--fps 200]
       [--port 29321] [--out serve_soak.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--fps", type=float, default=200.0,
                    help="offered UDP frame rate")
    ap.add_argument("--port", type=int, default=29321)
    ap.add_argument("--serve-batch", type=int, default=64)
    ap.add_argument("--out", default="serve_soak.json")
    ap.add_argument("--ready-timeout", type=float, default=900.0,
                    help="seconds to wait for serve's compile+ready")
    args = ap.parse_args()

    import numpy as np

    from mmradar.config import RadarConfig
    from mmradar.io.capture import write_capture
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    cfg = RadarConfig()
    workdir = tempfile.mkdtemp(prefix="serve_soak_")
    cap_path = os.path.join(workdir, "soak.bin")
    targets = [
        SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=15.0,
                    amplitude=2500.0),
        SceneTarget(range_m=9.0, velocity_mps=-1.0, azimuth_deg=-30.0,
                    amplitude=1500.0),
    ]
    write_capture(cap_path, np.asarray(
        synthesize_capture(targets, args.frames + 1, cfg, noise_std=5.0,
                           seed=11)))

    env = dict(os.environ)
    serve = subprocess.Popen(
        [sys.executable, "-m", "mmradar.cli", "serve",
         "--port", str(args.port), "--host", "127.0.0.1",
         "--timeout", "10", "--serve-batch", str(args.serve_batch)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env,
    )

    records: list[dict] = []
    stats: dict = {}
    ready_evt = threading.Event()

    def reader():
        for line in serve.stdout:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            ev = rec.get("event")
            if ev == "ready":
                ready_evt.set()
            elif ev == "latency_stats":
                stats.update(rec)
            elif ev is None:
                records.append(rec)

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()

    t0 = time.time()
    if not ready_evt.wait(args.ready_timeout):
        serve.kill()
        print("serve never became ready", file=sys.stderr)
        return 1
    t_ready = time.time() - t0
    print(f"serve ready in {t_ready:.1f}s; replaying {args.frames} frames "
          f"at {args.fps} fps offered", file=sys.stderr)

    t_replay0 = time.time()
    replay = subprocess.run(
        [sys.executable, "-m", "mmradar.cli", "replay", cap_path,
         "--port", str(args.port), "--host", "127.0.0.1",
         "--fps", str(args.fps)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600,
    )
    t_replay = time.time() - t_replay0
    if replay.returncode != 0:
        print(replay.stderr[-500:], file=sys.stderr)

    rc = serve.wait(timeout=120)
    rt.join(timeout=10)
    stderr_tail = serve.stderr.read()[-800:]

    n_rec = len(records)
    frames_served = max((r.get("frame", 0) for r in records), default=0)
    n_det = sum(1 for r in records if r.get("detections"))
    # sustained fps from the serve loop's own stderr summary when
    # present (first dispatch -> last record), else records / replay time
    sustained = None
    for ln in stderr_tail.splitlines():
        if "served" in ln and "fps" in ln:
            try:
                sustained = float(ln.split("=")[1].split("fps")[0])
            except (IndexError, ValueError):
                pass
    summary = {
        "artifact": "serve_soak",
        "offered_fps": args.fps,
        "frames_offered": args.frames,
        "frames_served": frames_served,
        "records": n_rec,
        "records_with_detections": n_det,
        "delivery_rate": round(frames_served / args.frames, 4),
        "sustained_fps": sustained,
        "replay_wall_s": round(t_replay, 2),
        "time_to_ready_s": round(t_ready, 1),
        "latency_stats": {k: v for k, v in stats.items() if k != "event"},
        "serve_rc": rc,
    }
    print(json.dumps(summary))
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    ok = rc == 0 and n_rec > 0 and n_det > 0 and stats
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
