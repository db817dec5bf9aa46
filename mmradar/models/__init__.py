from mmradar.models.range_detector import RangeDetector
from mmradar.models.rd_pipeline import RDPipeline, RDResult

__all__ = ["RangeDetector", "RDPipeline", "RDResult"]
