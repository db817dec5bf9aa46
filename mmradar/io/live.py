"""Live capture ingest: DCA1000-style UDP packet reassembly.

The reference only replays files (hardcoded ``./fhy_direct.bin``,
cudaBenchMarking.cpp:224); the capture card it models (TI DCA1000) actually
streams raw ADC data over UDP.  This module provides the missing live path:

* ``PacketReassembler`` — turns DCA1000 raw-mode datagrams into complete
  frames.  Packet layout (DCA1000 raw mode): 4-byte little-endian sequence
  number, 6-byte little-endian total-bytes-sent-before-this-packet, then
  up to 1456 bytes of payload.  Lost packets are zero-filled using the
  byte-offset field so frame alignment never drifts (the radar keeps
  transmitting regardless).
* ``udp_frames`` — generator reading datagrams from a UDP socket and
  yielding frames, for feeding ``parallel.stream.FrameStreamer`` batches.

Reassembly is pure host-side byte handling; frames come out as the same
int16 arrays the file reader produces, so the rest of the pipeline is
identical for live and replayed data.
"""

from __future__ import annotations

import socket
from typing import Iterator

import numpy as np

from mmradar.config import RadarConfig, DEFAULT_CONFIG

HEADER_BYTES = 10
DEFAULT_PAYLOAD = 1456


def make_packets(
    frames: np.ndarray,
    payload_bytes: int = DEFAULT_PAYLOAD,
    start_seq: int = 0,
) -> list[bytes]:
    """Encode a frame stream into DCA1000 raw-mode datagrams (for tests,
    replay tools and the synthetic live-source)."""
    data = np.ascontiguousarray(frames, dtype="<i2").tobytes()
    packets = []
    offset = 0
    seq = start_seq
    while offset < len(data):
        chunk = data[offset : offset + payload_bytes]
        header = seq.to_bytes(4, "little") + offset.to_bytes(6, "little")
        packets.append(header + chunk)
        offset += len(chunk)
        seq += 1
    return packets


class PacketReassembler:
    """Accumulates datagrams into whole radar frames.

    Out-of-order packets are held in a pending map keyed by byte offset and
    drained in order, so reorders within ``reorder_window`` packets are
    reassembled losslessly.  Only when the window overflows (genuine loss:
    the missing packet never arrives while later ones keep coming) is the
    gap zero-filled so the frame boundary stays aligned; ``dropped_bytes``
    counts exactly the zero-filled span.
    """

    def __init__(
        self, cfg: RadarConfig = DEFAULT_CONFIG, reorder_window: int = 32
    ):
        self.cfg = cfg
        self.frame_bytes = cfg.bytes_per_frame
        self.reorder_window = reorder_window
        self._buf = bytearray()
        self._pending: dict[int, bytes] = {}  # offset -> payload
        self._expected_offset = None  # byte offset of the next in-order byte
        self.dropped_bytes = 0
        self.packets_seen = 0

    def _drain(self) -> None:
        while self._pending:
            payload = self._pending.pop(self._expected_offset, None)
            if payload is not None:
                self._buf.extend(payload)
                self._expected_offset += len(payload)
                continue
            if len(self._pending) >= self.reorder_window:
                # the head packet is lost: zero-fill up to the earliest
                # pending offset and keep draining
                nxt = min(self._pending)
                gap = nxt - self._expected_offset
                self._buf.extend(b"\x00" * gap)
                self.dropped_bytes += gap
                self._expected_offset = nxt
                continue
            break  # wait for the missing packet

    def feed(self, packet: bytes) -> list[np.ndarray]:
        """Consume one datagram; return any frames completed by it."""
        if len(packet) <= HEADER_BYTES:
            return []
        self.packets_seen += 1
        offset = int.from_bytes(packet[4:10], "little")
        payload = packet[HEADER_BYTES:]

        if self._expected_offset is None:
            self._expected_offset = offset
        if offset >= self._expected_offset:
            self._pending[offset] = payload  # duplicate: last write wins
        # else: stale duplicate of already-consumed data -> drop
        self._drain()
        return self._pop_frames()

    def _pop_frames(self) -> list[np.ndarray]:
        frames = []
        while len(self._buf) >= self.frame_bytes:
            raw = bytes(self._buf[: self.frame_bytes])
            del self._buf[: self.frame_bytes]
            frames.append(np.frombuffer(raw, dtype="<i2"))
        return frames

    def flush(self) -> int:
        """Force-drain pending packets (zero-filling gaps); returns the
        number of bytes still buffered short of a frame boundary.  Call
        :meth:`_pop_frames` (or ``flush_frames``) afterwards to collect any
        frames the drain completed."""
        while self._pending:
            nxt = min(self._pending)
            if nxt > self._expected_offset:
                gap = nxt - self._expected_offset
                self._buf.extend(b"\x00" * gap)
                self.dropped_bytes += gap
                self._expected_offset = nxt
            payload = self._pending.pop(nxt)
            self._buf.extend(payload)
            self._expected_offset += len(payload)
        return len(self._buf)

    def flush_frames(self) -> list[np.ndarray]:
        """Force-drain pending packets and return the frames completed."""
        self.flush()
        return self._pop_frames()


def udp_frame_batches_multi(
    ports: list[int],
    cfg: RadarConfig = DEFAULT_CONFIG,
    host: str = "0.0.0.0",
    max_frames: int | None = None,
    timeout_s: float | None = 5.0,
    rcvbuf_bytes: int = 8 << 20,
    max_batch: int = 8,
    on_bound=None,
) -> Iterator[list[tuple[int, np.ndarray]]]:
    """Multi-source ingest: one UDP port per radar sensor (DCA1000 board),
    each with its own reassembler, multiplexed into one stream of
    ``(source_index, frame)`` batches.

    Frames from different sources batch together freely (detection is
    stateless per frame); the source index lets the caller keep per-sensor
    state (base frames, trackers).  ``max_frames`` counts across all
    sources; the timeout applies to the whole group (a stream ends when
    NO source delivers within ``timeout_s``).  ``on_bound`` runs once
    after every socket is bound.
    """
    import selectors

    sel = selectors.DefaultSelector()
    socks = []
    reasms = [PacketReassembler(cfg) for _ in ports]
    for i, port in enumerate(ports):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # SO_RCVBUFFORCE (Linux, root) bypasses rmem_max; only attempt it
        # where the constant exists — a hardcoded option number could set
        # an unrelated option on other platforms without raising
        try:
            if not hasattr(socket, "SO_RCVBUFFORCE"):
                raise OSError("SO_RCVBUFFORCE unavailable")
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_RCVBUFFORCE, rcvbuf_bytes
            )
        except OSError:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf_bytes)
        sock.bind((host, port))
        sock.setblocking(False)
        sel.register(sock, selectors.EVENT_READ, i)
        socks.append(sock)
    if on_bound is not None:
        on_bound()

    produced = 0
    pending: list[tuple[int, np.ndarray]] = []
    try:
        while max_frames is None or produced < max_frames:
            events = sel.select(timeout_s)
            if not events:
                # group timeout: flush every source's reorder-pending tail
                for i, reasm in enumerate(reasms):
                    pending.extend((i, f) for f in reasm.flush_frames())
                while pending:
                    n = max_batch if max_frames is None else min(
                        max_batch, max_frames - produced
                    )
                    if n <= 0:
                        return
                    yield pending[:n]
                    produced += len(pending[:n])
                    del pending[:n]
                return
            for key, _ in events:
                src = key.data
                # drain this socket without waiting; only EWOULDBLOCK ends
                # the drain — a genuine socket error must propagate, not
                # busy-spin through select() forever
                while True:
                    try:
                        packet, _ = key.fileobj.recvfrom(65535)
                    except BlockingIOError:
                        break
                    pending.extend(
                        (src, f) for f in reasms[src].feed(packet)
                    )
            while pending:
                n = max_batch if max_frames is None else min(
                    max_batch, max_frames - produced
                )
                if n <= 0:
                    return
                batch, pending = pending[:n], pending[n:]
                yield batch
                produced += len(batch)
    finally:
        for sock in socks:
            sel.unregister(sock)
            sock.close()
        sel.close()


def udp_frames(
    port: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    host: str = "0.0.0.0",
    max_frames: int | None = None,
    timeout_s: float | None = 5.0,
    rcvbuf_bytes: int = 8 << 20,
) -> Iterator[np.ndarray]:
    """Yield frames from a DCA1000-style UDP stream until timeout/count."""
    for batch in udp_frame_batches(
        port, cfg, host=host, max_frames=max_frames, timeout_s=timeout_s,
        rcvbuf_bytes=rcvbuf_bytes, max_batch=1,
    ):
        yield from batch


def udp_frame_batches(
    port: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    host: str = "0.0.0.0",
    max_frames: int | None = None,
    timeout_s: float | None = 5.0,
    rcvbuf_bytes: int = 8 << 20,
    max_batch: int = 8,
    on_bound=None,
) -> Iterator[list[np.ndarray]]:
    """Yield LISTS of frames: everything available without waiting, up to
    ``max_batch`` per yield.

    The serving pipeline dispatches one detection program per yield;
    where the per-dispatch cost dominates, batching the frames that have
    already arrived multiplies served throughput without adding latency
    beyond the first frame's (the drain uses a zero timeout — it never
    waits for frames that are not already in the kernel buffer).

    ``on_bound``, if given, runs right after the socket binds and before
    the first receive — the place for expensive warmup (compiles): packets
    arriving meanwhile accumulate in the kernel buffer instead of being
    lost to a closed port.
    """
    for batch in udp_frame_batches_multi(
        [port], cfg, host=host, max_frames=max_frames, timeout_s=timeout_s,
        rcvbuf_bytes=rcvbuf_bytes, max_batch=max_batch, on_bound=on_bound,
    ):
        yield [frame for _, frame in batch]
