from mmradar.ops.decode import decode_to_cube, rx0_slice
from mmradar.ops.preproc import clutter_subtract_pad
from mmradar.ops.rangefft import range_fft, range_doppler
from mmradar.ops.detect import (
    peak_detect,
    distance_from_bin,
    scan_window_argmax,
)
from mmradar.ops.cfar import ca_cfar_2d
from mmradar.ops.cluster import (
    ClusterResult,
    cluster_detections,
    label_hits,
    representatives,
)
from mmradar.ops.aoa import (
    angle_fft_spectrum,
    capon_spectrum,
    music_spectrum,
    angle_bins_deg,
    range_azimuth_capon_from_shorts,
    angle_doppler_from_shorts,
    range_azimuth_from_shorts,
)
from mmradar.ops.mdoppler import (
    auto_range_bin,
    micro_doppler_spectrogram,
)
from mmradar.ops.interference import blank_interference
from mmradar.ops.keystone import keystone_cube, keystone_matrices
from mmradar.ops.egomotion import (
    EgoMotion,
    ego_compensated_velocity,
    estimate_ego_motion,
    estimate_ego_motion_yaw,
    mount_rotation,
)

__all__ = [
    "decode_to_cube",
    "rx0_slice",
    "clutter_subtract_pad",
    "range_fft",
    "range_doppler",
    "peak_detect",
    "distance_from_bin",
    "scan_window_argmax",
    "ca_cfar_2d",
    "keystone_cube",
    "keystone_matrices",
    "EgoMotion",
    "estimate_ego_motion",
    "estimate_ego_motion_yaw",
    "mount_rotation",
    "ego_compensated_velocity",
    "ClusterResult",
    "cluster_detections",
    "representatives",
    "label_hits",
    "angle_fft_spectrum",
    "capon_spectrum",
    "music_spectrum",
    "angle_bins_deg",
    "range_azimuth_from_shorts",
    "range_azimuth_capon_from_shorts",
    "auto_range_bin",
    "micro_doppler_spectrogram",
    "blank_interference",
]
