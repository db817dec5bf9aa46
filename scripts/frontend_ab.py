#!/usr/bin/env python
"""Device-time A/B of the plain front-ends and of the two OS-CFAR forms.

On one resident batch of synthetic frames (the reference geometry,
``RadarConfig()``) it times, per batch, with ``utils.timing.onchip_time``
(the program looped on the device inside one dispatch):

* ``RDPipeline.maps`` and ``RDPipeline.detect`` for ``rd_impl`` 'fft',
  'mxu', 'planar' and 'fused' (library-default ``dft_precision``), and
  the 'fused' detect at the other two precisions;
* exact (stride-1) OS-CFAR on the same power maps: the one-pass counting
  form (``ops.cfar.os_cfar_hits``) against the sort form
  (``ops.cfar.os_cfar_2d``).

Variants run in turns, forward then backward, so drift shows as a
spread.  Prints the device (platform, kind, nvidia-smi name and power
limit) and one JSON line per round; meaningful only on the card.

Usage: python scripts/frontend_ab.py [--batch 512] [--rounds 2]
       [--out chiprun_out/frontend_ab.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp

    from mmradar.config import RadarConfig
    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.ops.cfar import os_cfar_2d, os_cfar_hits
    from mmradar.utils.compile_cache import enable_compile_cache
    from mmradar.utils.timing import onchip_time

    enable_compile_cache()
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip() if dev.platform == "gpu" else "n/a"
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"nvidia-smi: {smi}", flush=True)

    cfg = RadarConfig()
    cap = synthesize_capture(
        [SceneTarget(3.0, 2.0, 20.0, amplitude=2500.0),
         SceneTarget(8.0, -4.0, -35.0, amplitude=1500.0)],
        args.batch + 1, cfg, noise_std=5.0, seed=0)
    batch = jax.device_put(cap[1:])
    base = RDPipeline(cfg).prepare_base(cap[0])

    def pipe(impl, prec=cfg.dft_precision, kind="ca"):
        c = dataclasses.replace(cfg, dft_precision=prec, cfar_kind=kind)
        return RDPipeline(c, max_detections=16, rd_impl=impl)

    variants = {}
    for impl in ("fft", "mxu", "planar", "fused"):
        variants[f"maps {impl}"] = (pipe(impl).maps, batch, 32, None)
        variants[f"detect {impl}"] = (pipe(impl).detect, batch, 32, None)
    for prec in ("default", "highest"):
        variants[f"detect fused @{prec}"] = (pipe("fused", prec).detect,
                                            batch, 32, None)
    cfg_os = dataclasses.replace(cfg, cfar_kind="os")
    power = jax.block_until_ready(pipe("fft").maps(batch, base)[0])

    def f32_perturb(p, i):
        return p + i.astype(p.dtype) * jnp.float32(1e-30)

    variants["os hits: counting form"] = (
        lambda p: os_cfar_hits(p, cfg_os), power, 8, f32_perturb)
    variants["os hits: sort form"] = (
        lambda p: os_cfar_2d(p, cfg_os)[0], power, 2, f32_perturb)

    names = list(variants)
    results = {n: [] for n in names}
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            fn, x, iters, perturb = variants[n]
            b = None if perturb is not None else base
            dt = onchip_time(fn, x, b, iters=iters, reps=3, perturb=perturb)
            results[n].append(1e3 * dt)
            print(f"round {r} {n}: {1e3 * dt:.4f} ms/{args.batch} frames",
                  flush=True)
    summary = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "nvidia_smi": smi},
        "batch": args.batch,
        "ms_per_batch": results,
    }
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
