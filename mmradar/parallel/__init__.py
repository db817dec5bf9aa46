from mmradar.parallel.mesh import build_mesh, mesh_factorization
from mmradar.parallel.distributed import DistributedRDPipeline
from mmradar.parallel.stream import FrameStreamer, stream_detect

__all__ = [
    "build_mesh",
    "mesh_factorization",
    "DistributedRDPipeline",
    "FrameStreamer",
    "stream_detect",
]
