from mmradar.io.capture import (
    decode_frame,
    encode_frame,
    frames_in_file,
    read_capture,
    iter_frames,
    write_capture,
)
from mmradar.io.live import PacketReassembler, make_packets, udp_frames
from mmradar.io.synthetic import SceneTarget, synthesize_capture, synthesize_cube

__all__ = [
    "decode_frame",
    "encode_frame",
    "frames_in_file",
    "read_capture",
    "iter_frames",
    "write_capture",
    "SceneTarget",
    "synthesize_capture",
    "synthesize_cube",
    "PacketReassembler",
    "make_packets",
    "udp_frames",
]
