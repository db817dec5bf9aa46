"""Live UDP ingest: packet reassembly and loopback socket streaming."""

import socket
import threading

import numpy as np
import pytest

from mmradar.io.live import (
    DEFAULT_PAYLOAD,
    HEADER_BYTES,
    PacketReassembler,
    make_packets,
    udp_frames,
)
from mmradar.models.range_detector import RangeDetector
from mmradar import golden


def test_reassembly_roundtrip(cfg, capture):
    packets = make_packets(capture)
    reasm = PacketReassembler(cfg)
    frames = []
    for p in packets:
        frames.extend(reasm.feed(p))
    assert len(frames) == capture.shape[0]
    np.testing.assert_array_equal(np.stack(frames), capture)
    assert reasm.dropped_bytes == 0


def test_reassembly_with_packet_loss_keeps_alignment(cfg, capture):
    packets = make_packets(capture)
    # drop two packets in the middle of frame 2
    victim = [i for i in range(len(packets)) if 300 <= i <= 301]
    kept = [p for i, p in enumerate(packets) if i not in victim]
    reasm = PacketReassembler(cfg)
    frames = []
    for p in kept:
        frames.extend(reasm.feed(p))
    assert len(frames) == capture.shape[0]  # no drift: frame count intact
    assert reasm.dropped_bytes == 2 * DEFAULT_PAYLOAD
    # frames after the loss are bit-exact
    np.testing.assert_array_equal(frames[-1], capture[-1])
    np.testing.assert_array_equal(frames[0], capture[0])


def test_stale_duplicate_dropped(cfg, capture):
    packets = make_packets(capture[:1])
    reasm = PacketReassembler(cfg)
    frames = list(reasm.feed(packets[0]))
    frames += reasm.feed(packets[0])  # duplicate: must not corrupt
    for p in packets[1:]:
        frames.extend(reasm.feed(p))
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0], capture[0])


def test_udp_loopback_end_to_end(cfg, capture):
    """Stream a synthetic capture over a real UDP socket and detect from it."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()

    packets = make_packets(capture[:4])

    def send():
        import time

        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i, p in enumerate(packets):
            tx.sendto(p, ("127.0.0.1", port))
            if i % 64 == 63:
                time.sleep(0.001)  # don't outrun the loopback rcv buffer
        tx.close()

    gen = udp_frames(port, cfg, host="127.0.0.1", max_frames=4, timeout_s=10.0)
    t = threading.Timer(0.3, send)
    t.start()
    frames = list(gen)
    t.join()
    assert len(frames) == 4
    np.testing.assert_array_equal(np.stack(frames), capture[:4])

    # frames from the wire behave identically to file frames
    det = RangeDetector(cfg)
    out = det.detect_capture(np.stack(frames))
    want = golden.detect_capture(capture[:4], cfg)
    for i, w in enumerate(want):
        assert int(out.peak_bin[i]) == w.peak_bin


def test_serve_loopback(cfg, serve_over_udp):
    """cli serve: UDP frames in, JSONL detections + tracks out.

    The UDP race-avoidance scaffolding lives in the ``serve_over_udp``
    conftest fixture (shared with test_velocity's serve test).
    """
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    capture = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=0.0, azimuth_deg=15.0,
                     amplitude=3000.0)],
        5, cfg, noise_std=2.0, seed=71,
    )
    recs = serve_over_udp(capture)
    assert recs[0] == {"event": "ready"}
    assert recs[1] == {"event": "base_frame"}
    frame_recs = [r for r in recs if "frame" in r]
    assert len(frame_recs) == 4
    assert any(
        abs(d["range_m"] - 5.0) < 1.0
        for r in frame_recs for d in r["detections"]
    )
    # tracker confirms by the second frame
    assert frame_recs[-1]["tracks"]
    assert abs(frame_recs[-1]["tracks"][0]["range_m"] - 5.0) < 1.0
    # latency percentiles: real-time consumers need frame-to-detection
    # latency, not just throughput
    stats = [r for r in recs if r.get("event") == "latency_stats"]
    assert len(stats) == 1
    for field in ("p50_ms", "p90_ms", "p99_ms", "max_ms",
                  "detect_fetch_p50_ms", "detect_fetch_p99_ms"):
        assert stats[0][field] >= 0.0
    assert stats[0]["p50_ms"] <= stats[0]["p99_ms"] <= stats[0]["max_ms"]
    assert stats[0]["frames"] == 4


def test_serve_blank_interference(cfg, capsys):
    """serve --blank-interference: a jammed stream still yields the
    target, and the shutdown stats report the blanked-sample count."""
    import time
    from mmradar import cli
    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    import json as _json

    capture = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=0.0, azimuth_deg=15.0,
                     amplitude=3000.0)],
        5, cfg, noise_std=2.0, seed=71,
        interference_bursts=12, interference_amplitude=25000.0,
    )
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()

    packets = make_packets(capture)

    def send():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i, p in enumerate(packets):
            tx.sendto(p, ("127.0.0.1", port))
            if i % 64 == 63:
                time.sleep(0.001)
        tx.close()

    t = threading.Timer(0.5, send)
    t.start()
    rc = cli.main(["serve", "--port", str(port), "--host", "127.0.0.1",
                   "--max-frames", "5", "--timeout", "15",
                   "--blank-interference"])
    t.join()
    assert rc == 0
    recs = [_json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.strip()]
    frame_recs = [r for r in recs if "frame" in r]
    assert any(
        abs(d["range_m"] - 5.0) < 1.0
        for r in frame_recs for d in r["detections"]
    )
    stats = [r for r in recs if r.get("event") == "latency_stats"]
    assert len(stats) == 1
    assert stats[0]["blanked_samples"] > 0


def test_reorder_swap_is_lossless(cfg, capture):
    """Adjacent packet swap (classic UDP reorder) must reassemble exactly."""
    packets = make_packets(capture[:3])
    packets[50], packets[51] = packets[51], packets[50]
    packets[200], packets[201] = packets[201], packets[200]
    reasm = PacketReassembler(cfg)
    frames = []
    for p in packets:
        frames.extend(reasm.feed(p))
    assert reasm.dropped_bytes == 0
    assert len(frames) == 3
    np.testing.assert_array_equal(np.stack(frames), capture[:3])


def test_deep_reorder_within_window(cfg, capture):
    """A packet delayed by 10 positions still lands losslessly."""
    packets = make_packets(capture[:2])
    moved = packets.pop(30)
    packets.insert(40, moved)
    reasm = PacketReassembler(cfg)
    frames = []
    for p in packets:
        frames.extend(reasm.feed(p))
    assert reasm.dropped_bytes == 0
    np.testing.assert_array_equal(np.stack(frames), capture[:2])


def _free_port():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_udp_frame_batches_cover_stream(cfg, capture):
    """The micro-batching generator yields every frame, in order, with
    batches bounded by max_batch."""
    import time
    from mmradar.io.live import udp_frame_batches

    port = _free_port()
    packets = make_packets(capture[:6])

    def send():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i, p in enumerate(packets):
            tx.sendto(p, ("127.0.0.1", port))
            if i % 64 == 63:
                time.sleep(0.001)
        tx.close()

    gen = udp_frame_batches(port, cfg, host="127.0.0.1", max_frames=6,
                            timeout_s=10.0, max_batch=4)
    t = threading.Timer(0.3, send)
    t.start()
    batches = list(gen)
    t.join()
    assert all(1 <= len(b) <= 4 for b in batches)
    frames = [f for b in batches for f in b]
    assert len(frames) == 6
    np.testing.assert_array_equal(np.stack(frames), capture[:6])


def test_timeout_flushes_reorder_pending_final_frame(cfg, capture):
    """A final frame missing only a lost mid-packet (later packets held in
    the reorder-pending map) is zero-fill completed at timeout instead of
    silently dropped."""
    import time

    port = _free_port()
    packets = make_packets(capture[:2])
    lost = len(packets) - 3  # a packet near the end of frame 1
    kept = [p for i, p in enumerate(packets) if i != lost]

    def send():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i, p in enumerate(kept):
            tx.sendto(p, ("127.0.0.1", port))
            if i % 64 == 63:
                time.sleep(0.001)
        tx.close()

    gen = udp_frames(port, cfg, host="127.0.0.1", max_frames=2,
                     timeout_s=1.0)
    t = threading.Timer(0.2, send)
    t.start()
    frames = list(gen)
    t.join()
    assert len(frames) == 2
    np.testing.assert_array_equal(frames[0], capture[0])
    # the lost packet's span is zeroed; everything else bit-exact
    want = capture[1].copy()
    start = (lost * DEFAULT_PAYLOAD) % cfg.bytes_per_frame // 2
    want[start : start + DEFAULT_PAYLOAD // 2] = 0
    np.testing.assert_array_equal(frames[1], want)


def test_serve_two_sources(cfg, capsys):
    """Two UDP sources: per-source base frames and trackers, records tagged
    with their source index."""
    import time
    import json as _json
    from mmradar import cli
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    cap_a = synthesize_capture(
        [SceneTarget(range_m=4.0, velocity_mps=0.0, azimuth_deg=0.0,
                     amplitude=3000.0)], 4, cfg, noise_std=2.0, seed=81)
    cap_b = synthesize_capture(
        [SceneTarget(range_m=9.0, velocity_mps=0.0, azimuth_deg=0.0,
                     amplitude=3000.0)], 4, cfg, noise_std=2.0, seed=82)
    port_a, port_b = _free_port(), _free_port()

    def send():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for cap, port in [(cap_a, port_a), (cap_b, port_b)]:
            for i, p in enumerate(make_packets(cap)):
                tx.sendto(p, ("127.0.0.1", port))
                if i % 64 == 63:
                    time.sleep(0.001)
        tx.close()

    t = threading.Timer(0.5, send)
    t.start()
    rc = cli.main(["serve", "--port", str(port_a), "--port", str(port_b),
                   "--host", "127.0.0.1", "--max-frames", "8",
                   "--timeout", "15"])
    t.join()
    assert rc == 0
    recs = [_json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.strip()]
    bases = [r for r in recs if r.get("event") == "base_frame"]
    assert sorted(b["source"] for b in bases) == [0, 1]
    frames = [r for r in recs if "frame" in r]
    assert frames and {r["source"] for r in frames} == {0, 1}
    # each source's detections reflect ITS base frame and target
    for r in frames:
        want = 4.0 if r["source"] == 0 else 9.0
        assert any(abs(d["range_m"] - want) < 1.0 for d in r["detections"])


def test_serve_refine_loopback(cfg, capsys):
    """cli serve --refine capon actually executes the refinement path
    (regression: the packed result array must be writable for the
    in-place azimuth replacement)."""
    import time
    from mmradar import cli
    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    import json as _json

    capture = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=0.0, azimuth_deg=15.0,
                     amplitude=3000.0)],
        4, cfg, noise_std=2.0, seed=72,
    )
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()

    packets = make_packets(capture)

    def send():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i, p in enumerate(packets):
            tx.sendto(p, ("127.0.0.1", port))
            if i % 64 == 63:
                time.sleep(0.001)
        tx.close()

    t = threading.Timer(0.5, send)
    t.start()
    rc = cli.main(["serve", "--port", str(port), "--host", "127.0.0.1",
                   "--max-frames", "4", "--timeout", "15",
                   "--refine", "capon"])
    t.join()
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    recs = [_json.loads(l) for l in lines]
    frame_recs = [r for r in recs if "frame" in r]
    assert len(frame_recs) == 3
    # the refined azimuth stays on target
    best = [
        max(r["detections"], key=lambda d: d["power"])
        for r in frame_recs if r["detections"]
    ]
    assert best and all(abs(d["azimuth_deg"] - 15.0) < 4.0 for d in best)


def test_replay_feeds_serve(cfg, tmp_path, capsys):
    """cli replay -> cli serve over loopback: the full sensor-to-tracks
    demo without hardware (reference contrast: a hardcoded file path,
    cudaBenchMarking.cpp:224)."""
    import threading
    import time
    from mmradar import cli
    from mmradar.io.capture import write_capture
    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    import json as _json

    capture = synthesize_capture(
        [SceneTarget(range_m=6.0, velocity_mps=0.0, azimuth_deg=-10.0,
                     amplitude=3000.0)],
        5, cfg, noise_std=2.0, seed=73,
    )
    cap_path = tmp_path / "replay.bin"
    write_capture(cap_path, capture, cfg)

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()

    def replay():
        time.sleep(0.5)  # let serve bind + warm up
        cli.main(["replay", str(cap_path), "--port", str(port),
                  "--fps", "200"])

    t = threading.Thread(target=replay)
    t.start()
    rc = cli.main(["serve", "--port", str(port), "--host", "127.0.0.1",
                   "--max-frames", "5", "--timeout", "15"])
    t.join()
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    recs = [_json.loads(l) for l in lines]
    frame_recs = [r for r in recs if "frame" in r]
    assert len(frame_recs) == 4
    assert any(
        abs(d["range_m"] - 6.0) < 1.0
        for r in frame_recs for d in r["detections"]
    )
    assert frame_recs[-1]["tracks"]


def test_serve_integrate(cfg, serve_over_udp):
    """serve --integrate N: live non-coherent integration — one record
    per N-frame group, group alignment fixed by arrival order across
    micro-batches (the pending-buffer design), detections from the
    summed map with the integration-matched CFAR alpha.

    Reference contrast: the reference detects single spectra per frame
    (acceleration.cu:522) and has no streaming or integration story.
    """
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    # a MOVING target: fresh-noise clutter modes notch zero Doppler, so
    # a 0 m/s scatterer would be removed by the clutter filter itself.
    # 13 frames -> 3 groups of 4: the third group record confirms the
    # track under the round-5 confirm_hits=3 default
    capture = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=15.0,
                     amplitude=3000.0)],
        13, cfg, noise_std=2.0, seed=71,
    )
    # fresh-noise clutter mode: base subtraction would integrate the
    # base's own noise realization coherently (detect_integrated doc)
    recs = serve_over_udp(capture,
                          extra_args=("--integrate", "4",
                                      "--clutter", "mean"))
    frame_recs = [r for r in recs if "frame" in r]
    # 12 post-base frames -> exactly 3 groups of 4, whatever the
    # micro-batch sizes were; frame numbers advance by the whole group
    assert len(frame_recs) == 3
    assert all(r["integrated"] == 4 for r in frame_recs)
    assert [r["frame"] for r in frame_recs] == [4, 8, 12]
    assert any(
        abs(d["range_m"] - 5.0) < 1.0
        for r in frame_recs for d in r["detections"]
    )
    # the steady target survives integration in every group
    assert all(r["detections"] for r in frame_recs)
    # tracker updates once per group record
    assert frame_recs[-1]["tracks"]
    stats = [r for r in recs if r.get("event") == "latency_stats"]
    assert len(stats) == 1
    assert stats[0]["frames"] == 12  # frames served, not records


def test_serve_base_frames(cfg, serve_over_udp):
    """serve --base-frames K: the first K frames per source accumulate
    into ONE averaged base (quenched-noise floor /K); records start at
    the first post-base frame and the base_frame event reports K."""
    from mmradar.io.synthetic import SceneTarget, synthesize_capture

    capture = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=15.0,
                     amplitude=3000.0)],
        10, cfg, noise_std=2.0, seed=73, n_base=4,
    )
    recs = serve_over_udp(capture, extra_args=("--base-frames", "4"))
    base_ev = [r for r in recs if r.get("event") == "base_frame"]
    assert base_ev == [{"event": "base_frame", "frames": 4}]
    frame_recs = [r for r in recs if "frame" in r]
    assert len(frame_recs) == 6  # 10 frames - 4 base
    assert any(
        abs(d["range_m"] - 5.0) < 1.0
        for r in frame_recs for d in r["detections"]
    )
