"""Multi-chip sharding (8 virtual CPU devices) and streaming tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmradar.config import RadarConfig
from mmradar.models.rd_pipeline import RDPipeline
from mmradar.models.range_detector import RangeDetector
from mmradar.parallel.distributed import DistributedRDPipeline
from mmradar.parallel.mesh import build_mesh, mesh_factorization
from mmradar.parallel.stream import FrameStreamer, stream_detect


def test_mesh_factorization():
    assert mesh_factorization(8, 4) == (2, 4)
    assert mesh_factorization(4, 4) == (1, 4)
    assert mesh_factorization(2, 4) == (1, 2)
    assert mesh_factorization(1, 4) == (1, 1)
    assert mesh_factorization(3, 4) == (3, 1)
    assert mesh_factorization(6, 4) == (3, 2)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_distributed_matches_single_device(cfg, capture):
    mesh = build_mesh(n_devices=8, num_rx=cfg.num_rx)
    dist = DistributedRDPipeline(mesh=mesh, cfg=cfg, max_detections=8)
    single = RDPipeline(cfg, max_detections=8)

    # 8 frames -> 4 per data shard (data=2, chan=4)
    frames = capture[1:9]
    base_single = single.prepare_base(jnp.asarray(capture[0]))
    want = single.detect(jnp.asarray(frames), base_single)

    base = dist.prepare_base(capture[0])
    got = dist.detect(dist.shard_frames(frames), base)

    np.testing.assert_array_equal(np.asarray(got.num_hits), np.asarray(want.num_hits))
    np.testing.assert_array_equal(
        np.asarray(got.range_bin), np.asarray(want.range_bin)
    )
    np.testing.assert_array_equal(
        np.asarray(got.doppler_bin), np.asarray(want.doppler_bin)
    )
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(
        np.asarray(got.angle_bin), np.asarray(want.angle_bin)
    )
    np.testing.assert_allclose(
        np.asarray(got.power), np.asarray(want.power), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.range_m), np.asarray(want.range_m), rtol=1e-6
    )


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_distributed_runs_on_any_mesh(cfg, capture, n_devices):
    mesh = build_mesh(n_devices=n_devices, num_rx=cfg.num_rx)
    dist = DistributedRDPipeline(mesh=mesh, cfg=cfg, max_detections=4)
    data_size = mesh.shape["data"]
    frames = np.tile(capture[1:2], (data_size, 1))
    out = dist.detect(dist.shard_frames(frames), dist.prepare_base(capture[0]))
    out = jax.block_until_ready(out)
    assert out.range_bin.shape == (data_size, 4)
    # every data shard got the same frame -> identical results
    for f in range(1, data_size):
        np.testing.assert_array_equal(
            np.asarray(out.range_bin[f]), np.asarray(out.range_bin[0])
        )


def test_streamer_covers_all_frames(cfg, capture):
    streamer = FrameStreamer(capture, batch=4, cfg=cfg)
    assert streamer.num_batches == 3  # 9 frames after base, batch 4
    assert streamer.valid_frames(0) == 4
    assert streamer.valid_frames(2) == 1
    batches = list(streamer)
    assert len(batches) == 3
    assert batches[0].shape == (4, cfg.shorts_per_frame)
    # padded tail is zeros
    np.testing.assert_array_equal(np.asarray(batches[2][1:]), 0)
    np.testing.assert_array_equal(np.asarray(batches[2][0]), capture[9])


def test_stream_detect_matches_batch_detect(cfg, capture):
    det = RangeDetector(cfg)
    base = det.prepare_base(jnp.asarray(capture[0]))
    want = det.detect(jnp.asarray(capture[1:]), base)

    streamer = FrameStreamer(capture, batch=3, cfg=cfg)
    results = stream_detect(streamer, lambda b: det.detect(b, base))
    got_bins = np.concatenate(
        [np.asarray(r.peak_bin)[: streamer.valid_frames(i)]
         for i, r in enumerate(results)]
    )
    np.testing.assert_array_equal(got_bins, np.asarray(want.peak_bin))


def test_streamer_from_file(tmp_path, cfg, capture):
    from mmradar.io.capture import write_capture

    path = tmp_path / "cap.bin"
    write_capture(path, capture, cfg)
    streamer = FrameStreamer(str(path), batch=4, cfg=cfg)
    np.testing.assert_array_equal(streamer.base_frame, capture[0])
    assert streamer.num_batches == 3


@pytest.mark.parametrize("n", [3, 5, 6])
def test_dryrun_odd_device_counts(n):
    """__graft_entry__.dryrun_multichip on non-power-of-2 meshes."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(n)


def test_dryrun_survives_hostile_backend_env(monkeypatch):
    """Import __graft_entry__ and call dryrun_multichip directly from a
    process whose environment selects a (possibly unavailable) non-CPU
    platform: the dry run must still run on its own virtual CPU mesh,
    since in-process platform forcing is unreachable from an
    import-and-call path."""
    import __graft_entry__ as ge

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=2"
    )
    ge.dryrun_multichip(8)  # must not raise, must not inherit the 2


def test_distributed_planar_matches_single_device(cfg, capture):
    """Planar (split re/im) sharded pipeline == single-device planar."""
    mesh = build_mesh(n_devices=8, num_rx=cfg.num_rx)
    dist = DistributedRDPipeline(
        mesh=mesh, cfg=cfg, max_detections=8, rd_impl="planar"
    )
    single = RDPipeline(cfg, max_detections=8, rd_impl="planar",
                        cfar_impl="xla")
    frames = capture[1:9]
    want = single.detect(
        jnp.asarray(frames), single.prepare_base(jnp.asarray(capture[0]))
    )
    got = dist.detect(dist.shard_frames(frames), dist.prepare_base(capture[0]))
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.angle_bin),
                                  np.asarray(want.angle_bin))
    np.testing.assert_allclose(np.asarray(got.power), np.asarray(want.power),
                               rtol=1e-5)


def test_distributed_fused_matches_single_device(cfg, capture):
    """Interleave-matmul fused path, sharded == single-device fused."""
    mesh = build_mesh(n_devices=8, num_rx=cfg.num_rx)
    dist = DistributedRDPipeline(
        mesh=mesh, cfg=cfg, max_detections=8, rd_impl="fused"
    )
    single = RDPipeline(cfg, max_detections=8, rd_impl="fused",
                        cfar_impl="xla")
    frames = capture[1:9]
    want = single.detect(
        jnp.asarray(frames), single.prepare_base(jnp.asarray(capture[0]))
    )
    got = dist.detect(dist.shard_frames(frames), dist.prepare_base(capture[0]))
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.angle_bin),
                                  np.asarray(want.angle_bin))
    np.testing.assert_allclose(np.asarray(got.power), np.asarray(want.power),
                               rtol=1e-5)


def test_distributed_honors_cfar_kind(capture):
    """cfar_kind='os' must change detections identically in the sharded and
    single-device pipelines (it used to be silently ignored sharded)."""
    from mmradar.config import RadarConfig as RC

    os_cfg = RC(cfar_kind="os")
    mesh = build_mesh(n_devices=4, num_rx=os_cfg.num_rx)
    dist = DistributedRDPipeline(mesh=mesh, cfg=os_cfg, max_detections=8)
    single = RDPipeline(os_cfg, max_detections=8, cfar_impl="xla")
    frames = capture[1:2]
    want = single.detect(
        jnp.asarray(frames), single.prepare_base(jnp.asarray(capture[0]))
    )
    got = dist.detect(dist.shard_frames(frames), dist.prepare_base(capture[0]))
    np.testing.assert_array_equal(np.asarray(got.num_hits),
                                  np.asarray(want.num_hits))
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))


def test_distributed_rejects_unknown_rd_impl(cfg):
    mesh = build_mesh(n_devices=2, num_rx=cfg.num_rx)
    with pytest.raises(ValueError, match="fused-pallas"):
        DistributedRDPipeline(mesh=mesh, cfg=cfg, rd_impl="fused-pallas")
    with pytest.raises(ValueError, match="rd_impl"):
        DistributedRDPipeline(mesh=mesh, cfg=cfg, rd_impl="bogus")


def test_two_process_distributed(tmp_path):
    """The multi-host story executed for real: two OS processes, each with
    4 virtual CPU devices, joined by jax.distributed into one 8-device
    mesh running the SAME shard_map program — cross-process psum /
    all_gather via gloo (DCN stand-in).  Detections must match a
    single-process run of the identical mesh bit-for-bit on indices and
    to float tolerance on physics (collective reduction order may differ
    across transports)."""
    import subprocess
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from __graft_entry__ import cpu_mesh_env

    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    out_npz = tmp_path / "rank0.npz"
    env = cpu_mesh_env(4)
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "mmradar.parallel.multihost",
                "--coordinator", f"localhost:{port}",
                "--num-processes", "2",
                "--process-id", str(i),
                "--out", str(out_npz),
            ],
            env=env,
            cwd=str(__import__("pathlib").Path(__file__).parents[1]),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se[-3000:]}"
    assert "multihost worker OK: 2 processes" in outs[0][0]

    got = np.load(out_npz)
    assert int(got["num_processes"]) == 2
    mesh_shape = (int(got["mesh_data"]), int(got["mesh_chan"]))
    assert mesh_shape[0] * mesh_shape[1] == 8

    # single-process reference: same geometry, same 8-device mesh, same
    # program, in THIS process
    from mmradar.config import RadarConfig
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    cfg2 = RadarConfig(num_samples=32, num_chirps=16)
    mesh = build_mesh(n_devices=8, num_rx=cfg2.num_rx)
    assert (mesh.shape["data"], mesh.shape["chan"]) == mesh_shape
    pipe = DistributedRDPipeline(
        mesh=mesh, cfg=cfg2, max_detections=4, rd_impl="fused"
    )
    capture = synthesize_capture(
        [SceneTarget(range_m=3.0, velocity_mps=1.0, azimuth_deg=15.0)],
        num_frames=mesh.shape["data"] * 2 + 1,
        cfg=cfg2,
        seed=0,
    )
    base = pipe.prepare_base(capture[0])
    want = pipe.detect(pipe.shard_frames(capture[1:]), base)

    np.testing.assert_array_equal(got["num_hits"], np.asarray(want.num_hits))
    np.testing.assert_array_equal(got["range_bin"], np.asarray(want.range_bin))
    np.testing.assert_array_equal(
        got["doppler_bin"], np.asarray(want.doppler_bin)
    )
    np.testing.assert_array_equal(got["valid"], np.asarray(want.valid))
    np.testing.assert_array_equal(got["angle_bin"], np.asarray(want.angle_bin))
    np.testing.assert_allclose(got["power"], np.asarray(want.power), rtol=1e-5)
    np.testing.assert_allclose(
        got["range_m"], np.asarray(want.range_m), rtol=1e-6
    )
    np.testing.assert_allclose(
        got["azimuth_deg"], np.asarray(want.azimuth_deg), rtol=1e-4, atol=1e-4
    )


def test_distributed_fused_data_parallel_matches_single_device(cfg, capture):
    """Pure data parallel: each device runs the whole fused front-end on
    its frame shard (zero collectives) — matches the single-device fused
    path."""
    mesh = build_mesh(n_devices=8, num_rx=1)  # data-only mesh
    assert mesh.shape["chan"] == 1
    dist = DistributedRDPipeline(
        mesh=mesh, cfg=cfg, max_detections=8, rd_impl="fused",
        cfar_impl="auto",
    )
    single = RDPipeline(cfg, max_detections=8, rd_impl="fused")
    frames = capture[1:9]
    want = single.detect(
        jnp.asarray(frames), single.prepare_base(jnp.asarray(capture[0]))
    )
    got = dist.detect(dist.shard_frames(frames), dist.prepare_base(capture[0]))
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.num_hits),
                                  np.asarray(want.num_hits))
    np.testing.assert_allclose(np.asarray(got.power), np.asarray(want.power),
                               rtol=1e-5)


def test_distributed_fft_chan_sharded(cfg, capture):
    """chan>1 complex-cube FFT: each shard transforms its RX subset
    (partial power), psum over 'chan' completes the integration —
    detections match the single-device fft path; azimuth from gathered
    shard snapshots."""
    mesh = build_mesh(n_devices=8, num_rx=cfg.num_rx)  # (data=2, chan=4)
    assert mesh.shape["chan"] == 4
    dist = DistributedRDPipeline(
        mesh=mesh, cfg=cfg, max_detections=8, rd_impl="fft",
        cfar_impl="xla",
    )
    single = RDPipeline(cfg, max_detections=8, rd_impl="fft",
                        cfar_impl="xla")
    frames = capture[1:9]
    want = single.detect(
        jnp.asarray(frames), single.prepare_base(jnp.asarray(capture[0]))
    )
    got = dist.detect(dist.shard_frames(frames), dist.prepare_base(capture[0]))
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))
    np.testing.assert_array_equal(np.asarray(got.doppler_bin),
                                  np.asarray(want.doppler_bin))
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.angle_bin),
                                  np.asarray(want.angle_bin))
    # psum reassociates the RX sum: f32 roundoff only
    np.testing.assert_allclose(np.asarray(got.power), np.asarray(want.power),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.azimuth_deg),
                               np.asarray(want.azimuth_deg),
                               rtol=1e-4, atol=1e-3)


def test_distributed_fft_chan_sharded_mimo(capture):
    """chan-sharded fft under TDM-MIMO: the virtual-element permutation
    after the all_gather must still produce the single-device order."""
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    cfg2 = RadarConfig(num_tx=2)
    cap = synthesize_capture(
        [SceneTarget(5.0, 2.0, 15.0), SceneTarget(9.0, -1.0, -30.0)],
        9, cfg2, noise_std=2.0, seed=77,
    )
    mesh = build_mesh(n_devices=8, num_rx=cfg2.num_rx)
    dist = DistributedRDPipeline(
        mesh=mesh, cfg=cfg2, max_detections=8, rd_impl="fft",
        cfar_impl="xla",
    )
    single = RDPipeline(cfg2, max_detections=8, rd_impl="fft",
                        cfar_impl="xla")
    want = single.detect(
        jnp.asarray(cap[1:9]), single.prepare_base(jnp.asarray(cap[0]))
    )
    got = dist.detect(dist.shard_frames(cap[1:9]), dist.prepare_base(cap[0]))
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))
    np.testing.assert_array_equal(np.asarray(got.angle_bin),
                                  np.asarray(want.angle_bin))
    np.testing.assert_allclose(np.asarray(got.azimuth_deg),
                               np.asarray(want.azimuth_deg),
                               rtol=1e-4, atol=1e-3)


def test_two_process_udp_ingest(tmp_path):
    """Multi-host INGEST executed for real: two OS processes, each
    receiving only ITS OWN sensor's frames over UDP (first frame = the
    shared base), assembled into one globally-sharded batch with
    local_frames_to_global — raw cubes never leave their host — then the
    shared shard_map program detects across the 8-device mesh.  Rank-0's
    gathered detections must match a single-process run on the
    concatenated capture."""
    import subprocess
    import sys
    import time

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from __graft_entry__ import cpu_mesh_env

    import socket

    from mmradar.config import RadarConfig
    from mmradar.io.live import make_packets
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    cfg2 = RadarConfig(num_samples=32, num_chirps=16)
    capture = synthesize_capture(
        [SceneTarget(range_m=3.0, velocity_mps=1.0, azimuth_deg=15.0)],
        num_frames=5, cfg=cfg2, seed=0,
    )

    def free_port(kind=socket.SOCK_STREAM):
        s = socket.socket(socket.AF_INET, kind)
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    coord = free_port()
    udp_ports = [free_port(socket.SOCK_DGRAM) for _ in range(2)]
    out_npz = tmp_path / "rank0.npz"
    env = cpu_mesh_env(4)
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "mmradar.parallel.multihost",
                "--coordinator", f"localhost:{coord}",
                "--num-processes", "2",
                "--process-id", str(i),
                "--out", str(out_npz),
                "--udp-port", str(udp_ports[i]),
                "--frames-local", "2",
            ],
            env=env,
            cwd=str(__import__("pathlib").Path(__file__).parents[1]),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]

    # wait for both reassemblers to bind, then send each process its own
    # frames: base to both, frames 1-2 to rank 0, frames 3-4 to rank 1
    ready = [tmp_path / f"rank0.npz.rank{i}.ready" for i in range(2)]
    deadline = time.time() + 300
    while not all(r.exists() for r in ready):
        if time.time() > deadline:
            for p in procs:
                p.kill()
            outs = [p.communicate() for p in procs]
            raise AssertionError(
                f"workers never bound their sockets:\n{outs[0][1][-2000:]}"
                f"\n{outs[1][1][-2000:]}"
            )
        if any(p.poll() is not None for p in procs):
            # kill the survivor (blocked in distributed init / UDP wait)
            # before collecting output, or communicate() hangs on it
            for p in procs:
                if p.poll() is None:
                    p.kill()
            outs = [p.communicate(timeout=60) for p in procs]
            raise AssertionError(
                f"worker died early:\n{outs[0][1][-2000:]}\n{outs[1][1][-2000:]}"
            )
        time.sleep(0.2)

    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for rank, frames in ((0, capture[[0, 1, 2]]), (1, capture[[0, 3, 4]])):
        for i, pkt in enumerate(make_packets(frames)):
            tx.sendto(pkt, ("127.0.0.1", udp_ports[rank]))
            if i % 32 == 31:
                time.sleep(0.001)
    tx.close()

    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"ingest worker failed:\n{so}\n{se[-3000:]}"

    got = np.load(out_npz)
    assert int(got["num_processes"]) == 2

    # single-process reference on the concatenated frames, same mesh shape
    mesh = build_mesh(n_devices=8, num_rx=cfg2.num_rx)
    pipe = DistributedRDPipeline(
        mesh=mesh, cfg=cfg2, max_detections=4, rd_impl="fused"
    )
    base = pipe.prepare_base(capture[0])
    want = pipe.detect(pipe.shard_frames(capture[1:]), base)
    np.testing.assert_array_equal(got["range_bin"], np.asarray(want.range_bin))
    np.testing.assert_array_equal(got["valid"], np.asarray(want.valid))
    np.testing.assert_array_equal(got["num_hits"], np.asarray(want.num_hits))
    np.testing.assert_allclose(got["power"], np.asarray(want.power), rtol=1e-5)


def test_distributed_detect_objects_matches_single(cfg, capture):
    """Sharded detect_objects == single-device clustering, bit-for-bit
    on assignments/counts and tight on centroid physics."""
    mesh = build_mesh(n_devices=8, num_rx=cfg.num_rx)
    dist = DistributedRDPipeline(mesh=mesh, cfg=cfg, max_detections=8)
    single = RDPipeline(cfg, max_detections=8)

    frames = capture[1:9]
    base_single = single.prepare_base(jnp.asarray(capture[0]))
    want_rd, want_cl = single.detect_objects(jnp.asarray(frames), base_single)

    base = dist.prepare_base(capture[0])
    got_rd, got_cl = dist.detect_objects(dist.shard_frames(frames), base)

    np.testing.assert_array_equal(
        np.asarray(got_rd.valid), np.asarray(want_rd.valid)
    )
    np.testing.assert_array_equal(
        np.asarray(got_cl.cluster_id), np.asarray(want_cl.cluster_id)
    )
    np.testing.assert_array_equal(
        np.asarray(got_cl.num_clusters), np.asarray(want_cl.num_clusters)
    )
    np.testing.assert_array_equal(
        np.asarray(got_cl.cells), np.asarray(want_cl.cells)
    )
    np.testing.assert_allclose(
        np.asarray(got_cl.centroid_range_m),
        np.asarray(want_cl.centroid_range_m), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(got_cl.total_power),
        np.asarray(want_cl.total_power), rtol=1e-5,
    )


def test_distributed_base_stack_matches_single(cfg, capture):
    """Distributed prepare_base accepts the (K, shorts) averaged-base
    stack like the single-chip pipeline (MIGRATION round-5 notes) and
    detections stay bin-identical."""
    mesh = build_mesh(n_devices=8, num_rx=cfg.num_rx)
    dist = DistributedRDPipeline(mesh=mesh, cfg=cfg, max_detections=8)
    single = RDPipeline(cfg, max_detections=8)
    frames = capture[3:9]
    want = single.detect(jnp.asarray(frames),
                         single.prepare_base(jnp.asarray(capture[:3])))
    got = dist.detect(dist.shard_frames(frames),
                      dist.prepare_base(capture[:3]))
    np.testing.assert_array_equal(np.asarray(got.range_bin),
                                  np.asarray(want.range_bin))
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid))
