from mmradar.utils.timing import Timer, StageTimings, time_fn
from mmradar.utils.records import DetectionRecord, JsonlWriter

__all__ = ["Timer", "StageTimings", "time_fn", "DetectionRecord", "JsonlWriter"]
