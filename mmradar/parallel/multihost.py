"""Multi-host (multi-process) execution of the sharded pipeline.

The reference is strictly single-GPU/single-process
(cudaBenchMarking.cpp:374-378).  This design (SURVEY.md §2.3, DESIGN.md
§4) scales the same `shard_map` program across hosts: each host runs one
process, JAX's coordination service forms the global device mesh, and the
collectives (`psum` over 'chan', `all_gather` for AoA snapshots) ride
NVLink within a host and the network across hosts — no code change to
the pipeline itself, only process bootstrap plus host-local array
construction.

Pieces:

* :func:`initialize` — `jax.distributed.initialize` wrapper (coordinator
  bootstrap).
* :func:`host_to_global` — build a globally-sharded array from a
  host-replicated NumPy array (multi-process `device_put` replacement:
  every process contributes exactly its addressable shards).
* :func:`gather_detections` — allgather an RDResult across processes to
  host NumPy (for serving/inspection on rank 0).
* ``python -m mmradar.parallel.multihost`` — a worker entry used by the
  two-process CPU test (tests/test_parallel.py::test_two_process_distributed)
  to prove the path executes with real cross-process collectives (gloo on
  CPU, NCCL on GPUs).
"""

from __future__ import annotations

import numpy as np


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    **kwargs,
) -> None:
    """Join the JAX coordination service; after this, ``jax.devices()``
    is the GLOBAL device list spanning every process.

    The three arguments are explicit (nothing here detects a cluster);
    ``local_device_ids`` in ``kwargs`` pins the process to those local
    GPUs.  Call before any other JAX API touches a backend.
    """
    import jax

    jax.distributed.initialize(
        coordinator_address, num_processes, process_id, **kwargs
    )


def host_to_global(x, sharding):
    """Host array -> globally-sharded jax.Array.

    Single-process this is ``device_put``.  Multi-process, ``device_put``
    cannot place shards it cannot address, so each process supplies its
    addressable pieces of the (host-replicated) array via
    ``make_array_from_callback`` — every process must hold the same
    ``x`` (or at least valid data at its own shard indices).
    """
    import jax

    x = np.asarray(x)
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def local_frames_to_global(local_frames, sharding):
    """Per-process LOCAL frame batches -> one global array sharded over
    'data'.

    The multi-host INGEST primitive: each host's UDP reassemblers deliver
    only that host's sensor frames; process p's block becomes the p-th
    slice of the global batch, landing directly on p's local devices —
    raw cubes never cross DCN (SURVEY.md §2.3's plan).  Requires the
    mesh's 'data' axis to be outermost in process order (build_mesh's
    jax.devices() ordering guarantees it).
    """
    import jax

    local_frames = np.asarray(local_frames)
    if jax.process_count() == 1:
        return jax.device_put(local_frames, sharding)
    arr = jax.make_array_from_process_local_data(sharding, local_frames)
    if arr.shape[0] != local_frames.shape[0] * jax.process_count():
        # the 'data' axis does not span processes outermost (e.g. a mesh
        # where 'chan' crosses hosts): each process would silently supply
        # inconsistent data for replicated shards
        raise ValueError(
            f"local_frames_to_global: global batch {arr.shape[0]} != "
            f"local {local_frames.shape[0]} x {jax.process_count()} "
            "processes — the mesh's 'data' axis must span processes "
            "(build_mesh over jax.devices() guarantees it)"
        )
    return arr


def gather_detections(out):
    """Allgather a (possibly sharded) RDResult pytree to host NumPy on
    every process (tiled: concatenated along the sharded axis)."""
    import jax
    from jax.experimental import multihost_utils

    return jax.tree.map(
        lambda leaf: np.asarray(
            multihost_utils.process_allgather(leaf, tiled=True)
        ),
        out,
    )


def _worker(argv=None) -> int:
    """Two-process test worker: run the sharded pipeline on a synthetic
    capture and write rank-0's gathered detections to an .npz file.

    Every process synthesizes the identical capture (same seed), so
    host_to_global's callback serves consistent shard data without any
    host-side scatter.
    """
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames-per-data-shard", type=int, default=2)
    ap.add_argument("--num-samples", type=int, default=32)
    ap.add_argument("--num-chirps", type=int, default=16)
    ap.add_argument("--udp-port", type=int, default=None,
                    help="ingest mode: receive this process's frames over "
                         "UDP (first received frame = shared base frame) "
                         "instead of synthesizing them")
    ap.add_argument("--frames-local", type=int, default=2,
                    help="ingest mode: frames to receive after the base")
    args = ap.parse_args(argv)

    import jax

    # one card per process: two JAX processes on one card would each
    # reserve most of its memory (ignored by the CPU backend)
    initialize(args.coordinator, args.num_processes, args.process_id,
               local_device_ids=[args.process_id])

    from mmradar.config import RadarConfig
    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.parallel.distributed import DistributedRDPipeline
    from mmradar.parallel.mesh import build_mesh

    cfg = RadarConfig(
        num_samples=args.num_samples, num_chirps=args.num_chirps
    )
    mesh = build_mesh(num_rx=cfg.num_rx)  # all GLOBAL devices
    pipe = DistributedRDPipeline(
        mesh=mesh, cfg=cfg, max_detections=4, rd_impl="fused"
    )
    data_size = mesh.shape["data"]
    if args.udp_port is not None:
        # multi-host ingest: THIS process's sensors only; its frames land
        # on its local devices via local_frames_to_global — raw cubes
        # never cross DCN.  First received frame is the (shared) base.
        import pathlib

        from mmradar.io.live import udp_frame_batches

        ready = pathlib.Path(f"{args.out}.rank{args.process_id}.ready")
        received: list[np.ndarray] = []
        for batch in udp_frame_batches(
            args.udp_port, cfg, host="127.0.0.1",
            max_frames=1 + args.frames_local, timeout_s=60.0,
            on_bound=lambda: ready.write_text("ok"),
        ):
            received.extend(batch)
        if len(received) != 1 + args.frames_local:
            raise RuntimeError(
                f"rank {args.process_id}: expected {1 + args.frames_local} "
                f"frames over UDP, got {len(received)}"
            )
        base = pipe.prepare_base(received[0])
        frames = local_frames_to_global(
            np.stack(received[1:]), pipe.frame_sharding
        )
    else:
        capture = synthesize_capture(
            [SceneTarget(range_m=3.0, velocity_mps=1.0, azimuth_deg=15.0)],
            num_frames=data_size * args.frames_per_data_shard + 1,
            cfg=cfg,
            seed=0,
        )
        base = pipe.prepare_base(capture[0])
        frames = pipe.shard_frames(capture[1:])
    out = gather_detections(pipe.detect(frames, base))
    if jax.process_index() == 0:
        np.savez(
            args.out,
            mesh_data=mesh.shape["data"],
            mesh_chan=mesh.shape["chan"],
            num_processes=jax.process_count(),
            **out._asdict(),
        )
        print(
            f"multihost worker OK: {jax.process_count()} processes, "
            f"mesh={dict(mesh.shape)}, hits={out.num_hits.tolist()}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_worker())
