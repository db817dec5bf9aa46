"""Double-buffered host->device frame streaming.

The reference's per-frame loop crosses PCIe 4x and mallocs 6 buffers per
frame (acceleration.cu:435-519, SURVEY.md §3.2).  The replacement
exploits JAX's async dispatch: while the device computes on cube *k*, the
host decodes/uploads cube *k+1* (``jax.device_put`` is asynchronous), so
transfer and compute overlap without explicit streams.

``FrameStreamer`` chunks a capture (file or array) into fixed-size frame
batches ("cubes"); ``stream_detect`` drives a detection pipeline over them
with a two-deep pipeline.
"""

from __future__ import annotations

from typing import Callable, Iterator

import jax
import numpy as np

from mmradar.config import RadarConfig, DEFAULT_CONFIG
from mmradar.io.capture import read_capture


class FrameStreamer:
    """Chunk a capture into device-resident frame batches.

    The final partial batch is zero-padded to the batch size (static shapes
    keep one compiled program) and reported via ``valid_frames``.
    """

    def __init__(
        self,
        frames: np.ndarray | str,
        batch: int = 32,
        cfg: RadarConfig = DEFAULT_CONFIG,
        sharding: jax.sharding.Sharding | None = None,
        skip_first: bool = True,
    ):
        if isinstance(frames, (str, bytes)) or hasattr(frames, "__fspath__"):
            frames = read_capture(frames, cfg)
        self.all_frames = np.asarray(frames)
        self.base_frame = self.all_frames[0]
        self.frames = self.all_frames[1:] if skip_first else self.all_frames
        self.batch = batch
        self.cfg = cfg
        self.sharding = sharding

    @property
    def num_batches(self) -> int:
        return -(-len(self.frames) // self.batch)

    def valid_frames(self, batch_idx: int) -> int:
        start = batch_idx * self.batch
        return min(self.batch, len(self.frames) - start)

    def _upload(self, batch_idx: int) -> jax.Array:
        start = batch_idx * self.batch
        chunk = self.frames[start : start + self.batch]
        if len(chunk) < self.batch:
            pad = np.zeros(
                (self.batch - len(chunk),) + chunk.shape[1:], chunk.dtype
            )
            chunk = np.concatenate([chunk, pad], axis=0)
        if self.sharding is not None:
            return jax.device_put(chunk, self.sharding)
        return jax.device_put(chunk)

    def __iter__(self) -> Iterator[jax.Array]:
        """Yield device batches with one batch of upload lookahead."""
        if self.num_batches == 0:
            return
        next_buf = self._upload(0)
        for i in range(self.num_batches):
            current = next_buf
            if i + 1 < self.num_batches:
                next_buf = self._upload(i + 1)  # async H2D behind compute
            yield current


def stream_detect(
    streamer: FrameStreamer,
    detect_fn: Callable[[jax.Array], object],
) -> list[object]:
    """Drive ``detect_fn`` over all batches with upload/compute overlap.

    ``detect_fn`` must be jitted; results are NOT blocked on, so dispatch
    of batch k+1 overlaps device compute of batch k.  The caller blocks on
    the returned list (e.g. ``jax.block_until_ready``).
    """
    return [detect_fn(batch) for batch in streamer]
