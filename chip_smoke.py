#!/usr/bin/env python
"""Bring-up smoke run on one GPU: the main path end to end, at full width.

Usage::

    python chip_smoke.py [--seed 0] [--frames 512]
    python chip_smoke.py --four-cards      # the multi-card phase only

The deployment is the reference's: 1 TX x 4 RX, 128 chirps x 100
samples, 204,800 B per frame (``RadarConfig()``), on a resident batch of
``--frames`` synthetic frames made from ``--seed``.

Phases, in order; a failure in any of them exits non-zero and prints no
``ok`` line:

1. device: a GPU or nothing; its kind, count, name and power limit
   (``nvidia-smi``) and the compile-cache directory.
2. detect: ``cli generate`` + ``cli detect --full``; ``RDPipeline.detect``
   on the batch; 8 frames against the float64 golden model — RD power
   within 1e-3 relative to the map's peak, detection (doppler, range)
   indices equal.
3. detector variants on the same batch, each against its golden twin:
   mti2 clutter, non-coherent integration x4, OS-CFAR at stride 1 (the
   counting form, also bit-identical to the sort form), GOCA, SOCA,
   the clutter map, and the reference-parity ``RangeDetector``.
4. plain front-ends ('fft', 'mxu', 'planar', 'fused') against golden
   power at every ``dft_precision``.
5. served path: ``cli serve`` in this process, fed over loopback UDP by a
   sender thread that never touches JAX.

Detection indices must match exactly, except that a cell whose golden
power lies within 1e-3 of its golden threshold, or within the measured
power error of the front-end at hand, may flip; every such flip is
counted and printed.

The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import socket
import subprocess
import sys
import tempfile
import threading
import time

import jax
import numpy as np

from mmradar import cli, golden
from mmradar.config import RadarConfig
from mmradar.io.capture import decode_shorts
from mmradar.io.live import make_packets
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.range_detector import RangeDetector
from mmradar.models.rd_pipeline import RDPipeline
from mmradar.ops.cfar import os_cfar_2d, os_cfar_hits
from mmradar.parallel.distributed import DistributedRDPipeline
from mmradar.parallel.mesh import build_mesh
from mmradar.utils.compile_cache import enable_compile_cache

TOL = 1e-3            # the repo's golden gate (README, Verification)
K = 16                # detections per frame
GOLDEN_FRAMES = 8     # frames compared with the float64 model


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def ok_line(devices) -> str:
    """The run's last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# --------------------------------------------------------------------------
# golden twins (float64 NumPy)
# --------------------------------------------------------------------------

def golden_power(shorts, base_shorts, cfg):
    """(B, D, R) float64 RD power per ``cfg.clutter_mode`` ('auto' with
    a base frame, or an MTI canceller)."""
    x = decode_shorts(np.asarray(shorts), cfg)
    mode = cfg.effective_clutter(base_shorts is not None)
    if mode == "base":
        x = x - decode_shorts(np.asarray(base_shorts), cfg)
    else:
        x = golden.mti_filter(x, int(mode[-1]), axis=-2, stride=cfg.num_tx)
    rd = golden.range_doppler_map(golden.virtual_cube(x, cfg), cfg)
    return (rd.real ** 2 + rd.imag ** 2).sum(axis=-3)


def golden_cfar(power, cfg, n_pulses=None):
    """(hits, threshold) of ``cfg.cfar_kind`` on float64 maps."""
    n = cfg.cfar_pulses_effective if n_pulses is None else n_pulses
    kind = cfg.cfar_kind
    args = (power, cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa)
    if kind == "os":
        return golden.os_cfar_2d(*args, cfg.cfar_os_k_frac,
                                 cfg.cfar_range_mode, cfg.cfar_os_stride,
                                 n_pulses=n)
    if kind in ("goca", "soca"):
        return golden.go_so_cfar_2d(*args, kind=kind[:2],
                                    range_mode=cfg.cfar_range_mode,
                                    n_pulses=n)
    return golden.ca_cfar_2d(*args, range_mode=cfg.cfar_range_mode,
                             n_pulses=n)


def check_detections(name, res, power, hits, thresh, cfg, abs_err=0.0):
    """Device RDResult rows vs golden maps (frames = golden's leading
    axis): the valid (doppler, range) slots and the hit count per frame.
    ``abs_err`` is the device power map's measured absolute error; cells
    closer than that to their threshold count as marginal."""
    r_size = power.shape[-1]
    guard = cfg.range_edge_guard_effective
    hits = hits.copy()
    if guard:
        hits[..., r_size - guard:] = False
    if thresh is None:
        marginal = np.zeros(hits.shape, bool)
    else:
        marginal = (np.abs(power - thresh)
                    <= TOL * np.abs(thresh) + abs_err)
    valid = np.asarray(res.valid)
    d_bin = np.asarray(res.doppler_bin)
    r_bin = np.asarray(res.range_bin)
    n_hits = np.asarray(res.num_hits)
    exact = n_det = flips = 0
    for f in range(power.shape[0]):
        flat = np.where(hits[f], power[f], -np.inf).ravel()
        order = np.argsort(-flat, kind="stable")[:K]
        want = {(int(i) // r_size, int(i) % r_size)
                for i in order if np.isfinite(flat[i])}
        got = {(int(d), int(r))
               for d, r, v in zip(d_bin[f], r_bin[f], valid[f]) if v}
        dh = abs(int(n_hits[f]) - int(hits[f].sum()))
        n_det += len(want)
        if want == got and dh == 0:
            exact += 1
            continue
        n_marg = int(marginal[f].sum())
        check(all(marginal[f][c] for c in want ^ got) and dh <= n_marg,
              f"{name}: frame {f} detections differ from golden: "
              f"device {sorted(got)} vs golden {sorted(want)}, hit count "
              f"{int(n_hits[f])} vs {int(hits[f].sum())}")
        flips += dh
    log(f"  {name}: {exact}/{power.shape[0]} frames exact vs golden, "
        f"{n_det} detections, {flips} marginal-cell flips "
        f"(|p - T| <= {TOL} T + {abs_err:.3g})")


def head(res, n: int):
    """The first ``n`` frames of a batched result."""
    return jax.tree.map(lambda a: a[:n], res)


def power_error(got, want) -> float:
    """Largest error relative to the map's peak (the repo's gate form)."""
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(need: int):
    cache = enable_compile_cache()
    devices = jax.devices()
    d = devices[0]
    check(d.platform == "gpu",
          f"no GPU: JAX's first device is on platform {d.platform!r}")
    check(len(devices) >= need,
          f"{need} GPUs needed, {len(devices)} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[1 device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devices)}")
    log("  nvidia-smi --query-gpu=name,power.limit:")
    for line in smi.splitlines():
        log(line)
    log(f"  compile cache: {cache}")


def make_capture(cfg, frames: int, seed: int):
    targets = [
        SceneTarget(3.0, 2.0, 20.0, amplitude=2500.0),
        SceneTarget(8.0, -4.0, -35.0, amplitude=1500.0),
        SceneTarget(12.0, 1.5, 10.0, amplitude=600.0),
    ]
    return synthesize_capture(targets, frames + 1, cfg, noise_std=5.0,
                              seed=seed)


def phase_detect(cfg, capture, seed: int):
    log("[2 detect]")
    with tempfile.TemporaryDirectory() as tmp:
        cap, out = f"{tmp}/cap.bin", f"{tmp}/dets.jsonl"
        rc = cli.main(["generate", cap, "--frames", "16", "--seed",
                       str(seed), "--target", "5.0,2.0,15",
                       "--target", "9.0,-1.0,-30,1500"])
        check(rc == 0, f"cli generate rc={rc}")
        rc = cli.main(["detect", cap, "--full", "--out", out])
        check(rc == 0, f"cli detect --full rc={rc}")
        with open(out) as f:
            recs = [json.loads(line) for line in f if line.strip()]
    near = [d["range_m"] for r in recs for d in r["detections"]
            if abs(d["range_m"] - 5.0) < 1.0]
    check(len(recs) == 15 and near,
          f"cli detect --full: {len(recs)} records, none near 5 m")
    log(f"  cli generate + detect --full: {len(recs)} records, "
        f"{sum(len(r['detections']) for r in recs)} detections")

    pipe = RDPipeline(cfg, max_detections=K)
    base = pipe.prepare_base(capture[0])
    batch = jax.device_put(capture[1:])
    t0 = time.perf_counter()
    res = jax.block_until_ready(pipe.detect(batch, base))
    log(f"  RDPipeline.detect on {batch.shape[0]} frames "
        f"(rd_impl resolves to {pipe._resolve_rd_impl()!r}; first call, "
        f"compile included: {time.perf_counter() - t0:.1f} s)")
    valid = np.asarray(res.valid)
    check(res.range_bin.shape == (batch.shape[0], K), "result shape")
    check(bool(valid.any(axis=1).all()), "a frame without detections")
    for name in ("range_m", "velocity_mps", "azimuth_deg", "power"):
        check(bool(np.isfinite(np.asarray(getattr(res, name))[valid]).all()),
              f"non-finite {name}")

    g = GOLDEN_FRAMES
    gp = golden_power(capture[1:1 + g], capture[0], cfg)
    power, _ = pipe.maps(batch[:g], base)
    err = power_error(power, gp)
    log(f"  RD power vs float64 golden: {err:.3e} of the peak "
        f"(gate {TOL}; float32, FFT library transforms)")
    check(err < TOL, f"RD power error {err:.3e} >= {TOL}")
    check_detections("detect (ca)", head(res, g), gp,
                     *golden_cfar(gp, cfg), cfg)
    return pipe, base, batch, gp


def phase_variants(cfg, capture, pipe, base, batch, gp):
    log("[3 detector variants]")
    g = GOLDEN_FRAMES

    cfg_mti = RadarConfig(clutter_mode="mti2")
    p = RDPipeline(cfg_mti, max_detections=K, use_base_frame=False)
    res = p.detect(batch)
    gp_mti = golden_power(capture[1:1 + g], None, cfg_mti)
    check_detections("clutter_mode='mti2'", head(res, g), gp_mti,
                     *golden_cfar(gp_mti, cfg_mti), cfg_mti)

    n = 4
    res = pipe.detect_integrated(batch, base, n)
    check(res.range_bin.shape[0] == batch.shape[0] // n, "integrate shape")
    p_int = gp.reshape((g // n, n) + gp.shape[1:]).sum(axis=1)
    check_detections(f"detect_integrated(n={n})", head(res, g // n), p_int,
                     *golden_cfar(p_int, cfg, n * cfg.cfar_pulses_effective),
                     cfg)

    cfg_os = RadarConfig(cfar_kind="os")
    p = RDPipeline(cfg_os, max_detections=K)
    res = p.detect(batch, base)
    check_detections("cfar_kind='os' stride 1 (counting form)", head(res, g),
                     gp, *golden_cfar(gp, cfg_os), cfg_os)
    nf = 64
    power, _ = p.maps(batch[:nf], base)
    count = jax.jit(os_cfar_hits, static_argnums=1)(power, cfg_os)
    sort = jax.jit(os_cfar_2d, static_argnums=1)(power, cfg_os)[0]
    count, sort = np.asarray(count), np.asarray(sort)
    check(np.array_equal(count, sort),
          f"OS counting form differs from the sort form in "
          f"{int((count != sort).sum())} cells")
    log(f"  OS counting form == sort form bit for bit over {nf} frames "
        f"({int(count.sum())} hits)")

    for kind in ("goca", "soca"):
        c = RadarConfig(cfar_kind=kind)
        res = RDPipeline(c, max_detections=K).detect(batch, base)
        check_detections(f"cfar_kind={kind!r}", head(res, g), gp,
                         *golden_cfar(gp, c), c)

    nc, block, beta = 48, 16, 0.25
    res, m_out = pipe.detect_cmap(batch[:nc], base, beta=beta, block=block)
    gp_c = golden_power(capture[1:1 + nc], capture[0], cfg)
    hits_c, m_want = golden.clutter_map_cfar(
        gp_c, cfg.cfar_pfa, beta, None, block, cfg.cfar_pulses_effective)
    check(power_error(m_out, m_want) < TOL, "clutter map state differs")
    check_detections("detect_cmap", res, gp_c, hits_c, None, cfg)

    det = RangeDetector(cfg)
    out = det.detect(batch, det.prepare_base(capture[0]))
    want = golden.detect_capture(capture[:1 + g], cfg)
    got = np.asarray(out.peak_bin)[:g]
    check([w.peak_bin for w in want] == got.tolist(),
          f"RangeDetector peak bins {got.tolist()} vs golden "
          f"{[w.peak_bin for w in want]}")
    mag = np.asarray(out.peak_magnitude)[:g]
    rel = max(abs(m - w.peak_magnitude) / w.peak_magnitude
              for m, w in zip(mag, want))
    check(rel < TOL, f"RangeDetector magnitude error {rel:.3e}")
    log(f"  RangeDetector (16K FFT): peak bins exact on {g} frames, "
        f"magnitude within {rel:.1e}; {out.peak_bin.shape[0]} frames run")


def phase_frontends(cfg, base, batch, gp):
    log("[4 plain front-ends] RD power vs float64 golden, error relative "
        f"to the map's peak (gate {TOL} at the library default "
        f"dft_precision={cfg.dft_precision!r})")
    g = GOLDEN_FRAMES
    peak = float(np.abs(gp).max())
    for impl in ("fft", "mxu", "planar", "fused"):
        precs = ("high", "highest", "default") if impl != "fft" else ("high",)
        for prec in precs:
            c = RadarConfig(dft_precision=prec)
            p = RDPipeline(c, max_detections=K, rd_impl=impl)
            err = power_error(p.maps(batch[:g], base)[0], gp)
            gated = prec == cfg.dft_precision
            note = ("FFT library, float32; ignores dft_precision"
                    if impl == "fft" else f"dft_precision={prec!r}")
            log(f"  rd_impl={impl!r} {note}: {err:.3e}"
                + ("" if gated else " (reported, not gated)"))
            if gated:
                check(err < TOL, f"{impl} power error {err:.3e} >= {TOL}")
                err_gated = err
        res = RDPipeline(cfg, max_detections=K, rd_impl=impl).detect(
            batch, base)
        check_detections(f"rd_impl={impl!r} detect",
                         head(res, g), gp,
                         *golden_cfar(gp, cfg), cfg,
                         abs_err=err_gated * peak)


class _Tee(io.StringIO):
    """Captures the server's stdout and flags its 'ready' event."""

    def __init__(self):
        super().__init__()
        self.ready = threading.Event()

    def write(self, s):
        if '"ready"' in s:
            self.ready.set()
        return super().write(s)


def phase_serve(capture, frames: int):
    log(f"[5 served path] cli serve <- loopback UDP, {frames} frames")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    packets = make_packets(capture[:frames + 1])
    per_frame = -(-len(packets) // (frames + 1))
    out = _Tee()

    def send():
        # the sender stays off JAX: plain sockets on prepared packets
        if not out.ready.wait(600):
            return
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for _ in range(2):  # the second pass heals loopback drops
            for i, pkt in enumerate(packets):
                tx.sendto(pkt, ("127.0.0.1", port))
                if i % per_frame == per_frame - 1:
                    time.sleep(0.002)
            time.sleep(0.2)
        tx.close()

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["serve", "--port", str(port), "--host", "127.0.0.1",
                       "--max-frames", str(frames + 1), "--timeout", "20"])
    out.ready.set()
    sender.join()
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.strip().startswith("{")]
    recs = [r for r in lines if "event" not in r]
    stats = [r for r in lines if r.get("event") == "latency_stats"]
    with_dets = sum(1 for r in recs if r.get("detections"))
    check(rc == 0, f"cli serve rc={rc}")
    check(with_dets > 0, f"served {len(recs)} records, none with detections")
    check(bool(stats), "no latency_stats line")
    st = {k: v for k, v in stats[-1].items() if k != "event"}
    log(f"  {len(recs)} records, {with_dets} with detections; "
        f"latency_stats {json.dumps(st)}")


def phase_four_cards(cfg, capture):
    log("[four cards] DistributedRDPipeline vs single-card RDPipeline")
    frames = capture[1:]
    for impl, num_rx in (("fused", 1), ("fft", cfg.num_rx)):
        mesh = build_mesh(n_devices=4, num_rx=num_rx)
        dist = DistributedRDPipeline(mesh=mesh, cfg=cfg, max_detections=K,
                                     rd_impl=impl)
        got = dist.detect(dist.shard_frames(frames),
                          dist.prepare_base(capture[0]))
        single = RDPipeline(cfg, max_detections=K, rd_impl=impl)
        want = single.detect(jax.device_put(frames, jax.devices()[0]),
                             single.prepare_base(capture[0]))
        for name in ("num_hits", "doppler_bin", "range_bin", "valid",
                     "angle_bin"):
            a = np.asarray(getattr(got, name))
            b = np.asarray(getattr(want, name))
            check(np.array_equal(a, b),
                  f"{impl} mesh {dict(mesh.shape)}: {name} differs from "
                  f"single-card in {int((a != b).sum())} slots")
        az = float(np.abs(np.asarray(got.azimuth_deg)
                          - np.asarray(want.azimuth_deg)).max())
        log(f"  rd_impl={impl!r} mesh={dict(mesh.shape)}: bins exact vs "
            f"single-card on {frames.shape[0]} frames "
            f"(max azimuth diff {az:.2e} deg)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=512,
                    help="resident batch (frames after the base frame)")
    ap.add_argument("--serve-frames", type=int, default=200)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    try:
        phase_device(4 if args.four_cards else 1)
        cfg = RadarConfig()
        capture = make_capture(cfg, args.frames, args.seed)
        if args.four_cards:
            phase_four_cards(cfg, capture)
        else:
            pipe, base, batch, gp = phase_detect(cfg, capture, args.seed)
            phase_variants(cfg, capture, pipe, base, batch, gp)
            phase_frontends(cfg, base, batch, gp)
            phase_serve(capture, args.serve_frames)
    except (SmokeFailure, subprocess.CalledProcessError, OSError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(ok_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
