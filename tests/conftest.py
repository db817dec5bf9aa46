"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Correctness tests never need an accelerator (mirroring how the reference
needs no cluster); multi-device sharding tests run against
``--xla_force_host_platform_device_count=8``.  Must run before jax imports.
Card-only checks are phases of ``chip_smoke.py``, not tests.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# entry points (cli.main) point the persistent compile cache into the
# checkout; CPU test compiles are not worth keeping there
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mmradar.config import RadarConfig  # noqa: E402
from mmradar.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402


@pytest.fixture(scope="session")
def cfg() -> RadarConfig:
    return RadarConfig()


@pytest.fixture(scope="session")
def targets() -> list[SceneTarget]:
    return [
        SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                    amplitude=2500.0),
        SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                    amplitude=1500.0),
    ]


@pytest.fixture(scope="session")
def capture(cfg, targets) -> np.ndarray:
    """A 10-frame synthetic capture (frame 0 = base frame)."""
    return synthesize_capture(targets, num_frames=10, cfg=cfg, seed=42)


@pytest.fixture
def serve_over_udp(capsys):
    """Run ``cli serve`` against a loopback UDP replay of a capture and
    return the parsed JSONL records.

    Encapsulates the race-avoidance scaffolding every serve test needs:
    ephemeral-port pick, a PASSIVE bind-readiness probe via
    /proc/net/udp (an active bind-probe could itself own the port at the
    server's bind instant — io/live.py sets no SO_REUSEADDR — turning a
    flake into an EADDRINUSE crash), paced sending, and a full replay
    pass (the reassembler drops stale duplicates by design, so the
    replay is free and heals first-pass loopback drops before the
    32-packet reorder window zero-fills the gap).
    """
    import json as _json
    import socket
    import threading
    import time

    from mmradar import cli
    from mmradar.io.live import make_packets

    def run(capture, extra_args=(), max_frames=None):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("no loopback sockets in sandbox")
        port = sock.getsockname()[1]
        sock.close()
        packets = make_packets(capture)
        if max_frames is None:
            max_frames = len(capture)

        def port_bound() -> bool:
            needle = f":{port:04X}"
            for path in ("/proc/net/udp", "/proc/net/udp6"):
                try:
                    with open(path) as f:
                        lines = f.readlines()[1:]
                except OSError:
                    continue
                if any(l.split()[1].endswith(needle) for l in lines):
                    return True
            return False

        def send():
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not port_bound():
                time.sleep(0.05)
            tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for _ in range(2):
                for i, p in enumerate(packets):
                    tx.sendto(p, ("127.0.0.1", port))
                    if i % 32 == 31:
                        time.sleep(0.001)
                time.sleep(0.2)
            tx.close()

        t = threading.Timer(0.0, send)
        t.start()
        rc = cli.main(["serve", "--port", str(port), "--host", "127.0.0.1",
                       "--max-frames", str(max_frames), "--timeout", "15",
                       *extra_args])
        t.join()
        assert rc == 0
        return [_json.loads(l)
                for l in capsys.readouterr().out.splitlines() if l.strip()]

    return run
