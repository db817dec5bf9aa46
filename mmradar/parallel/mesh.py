"""Device mesh construction.

The scaling axes for radar detection (SURVEY.md §2.2):

* ``data``  — frames.  The dominant axis: frames are independent, so DP is
  embarrassingly parallel and collectives-free.
* ``chan``  — RX channels (tensor-parallel-flavored).  The range-Doppler
  transform is per-RX independent; non-coherent integration is a ``psum``
  and AoA snapshot assembly an ``all_gather`` over this axis, riding the
  device interconnect (NVLink between the cards of one host).

The reference has neither (single GPU, serial frames —
cudaBenchMarking.cpp:374-378); this module is where the rebuild scales
past it.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
CHAN_AXIS = "chan"


def mesh_factorization(n_devices: int, num_rx: int = 4) -> tuple[int, int]:
    """Split ``n_devices`` into (data, chan) with chan | num_rx.

    Prefers the largest channel group that divides both the device count
    and the RX count, so the AoA all_gather stays one hop wide.
    """
    chan = 1
    for c in range(min(n_devices, num_rx), 0, -1):
        if n_devices % c == 0 and num_rx % c == 0:
            chan = c
            break
    return n_devices // chan, chan


def build_mesh(
    devices=None, n_devices: int | None = None, num_rx: int = 4
) -> Mesh:
    """Build a (data, chan) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    data, chan = mesh_factorization(len(devices), num_rx)
    import numpy as np

    arr = np.asarray(devices).reshape(data, chan)
    return Mesh(arr, (DATA_AXIS, CHAN_AXIS))
