"""Multi-chip range-Doppler-CFAR-AoA pipeline via shard_map.

Sharding layout over the (data, chan) mesh of :mod:`mmradar.parallel.mesh`:

* raw frames:  P('data', None)         — frames split across 'data'
* base cube:   P('chan', None, None)   — RX channels split across 'chan'
* results:     P('data', ...)          — replicated across 'chan'

Per-shard dataflow (collectives ride the device interconnect, NVLink
between the cards of one host):

  decode local frames -> slice my RX group -> subtract my base slice ->
  per-RX range-Doppler -> partial power -> **psum over 'chan'** ->
  CFAR + top-K (replicated compute on the summed map) ->
  gather my RX snapshot slice -> **all_gather over 'chan'** -> angle-FFT.

This is the multi-device replacement for what the reference cannot do at
all (single GPU, serial frames — SURVEY.md §2.2/§2.3).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmradar.config import RadarConfig, DEFAULT_CONFIG
from mmradar.models.impls import resolve_impl
from mmradar.models.rd_pipeline import (
    RDResult,
    assemble_result,
    gather_snapshots,
    integrate_power,
    virtualize_cube,
)
from mmradar.ops.decode import decode_to_cube
from mmradar.ops.rangefft import range_doppler
from mmradar.parallel.mesh import CHAN_AXIS, DATA_AXIS, build_mesh


class DistributedRDPipeline:
    """shard_map-based multi-chip detector.

    Usage::

        pipe = DistributedRDPipeline(mesh=build_mesh(), cfg=cfg)
        base = pipe.prepare_base(frame0)        # sharded over 'chan'
        out = pipe.detect(frames, base)          # frames sharded over 'data'
    """

    def __init__(
        self,
        mesh: Mesh | None = None,
        cfg: RadarConfig = DEFAULT_CONFIG,
        max_detections: int = 16,
        rd_impl: str = "fft",
        cfar_impl: str = "xla",
    ):
        rd_impl = resolve_impl("rd_impl", rd_impl)
        resolve_impl("cfar_impl", cfar_impl)
        self.mesh = mesh if mesh is not None else build_mesh(num_rx=cfg.num_rx)
        self.cfg = cfg
        self.max_detections = max_detections
        self.rd_impl = rd_impl
        self.cfar_impl = cfar_impl
        self.chan_size = self.mesh.shape[CHAN_AXIS]
        if cfg.num_rx % self.chan_size:
            raise ValueError(
                f"chan mesh axis ({self.chan_size}) must divide num_rx "
                f"({cfg.num_rx})"
            )
        self.rx_per_shard = cfg.num_rx // self.chan_size
        self._detect = self._build_detect()

    # -- shardings ----------------------------------------------------------
    @property
    def frame_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(DATA_AXIS, None))

    @property
    def base_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(CHAN_AXIS, None, None))

    def shard_frames(self, shorts) -> jax.Array:
        """Host frames -> global array sharded over 'data'.  Works both
        single-process and multi-host (every process passes the same host
        batch; see parallel.multihost.host_to_global)."""
        from mmradar.parallel.multihost import host_to_global

        return host_to_global(shorts, self.frame_sharding)

    def prepare_base(self, frame0_shorts) -> jax.Array:
        """Decode the base to a full cube, shard RX over 'chan'.

        Accepts one frame or a ``(K, shorts)`` stack, averaged like
        ``RDPipeline.prepare_base`` (the multi-frame quenched-noise
        mitigation, MIGRATION round-5 notes)."""
        cube = decode_to_cube(jnp.asarray(frame0_shorts), self.cfg)
        if cube.ndim == 4:
            cube = jnp.mean(cube, axis=0)
        if jax.process_count() == 1:
            # device->device reshard; the cube never visits the host
            return jax.device_put(cube, self.base_sharding)
        import numpy as np

        from mmradar.parallel.multihost import host_to_global

        return host_to_global(np.asarray(cube), self.base_sharding)

    # -- the sharded program --------------------------------------------------
    def _build_detect(self, with_clusters: bool = False):
        cfg = self.cfg
        k = self.max_detections
        rx_per = self.rx_per_shard
        chan = self.chan_size
        rd_impl = self.rd_impl

        # Virtual-element reordering after the all_gather: the gathered axis
        # is shard-major (shard, tx, local_rx) but the steering model wants
        # v = tx*num_rx + rx with rx = shard*rx_per + local_rx.
        perm = None
        if cfg.num_tx > 1:
            perm = []
            for v in range(cfg.num_virtual_rx):
                tx, r = divmod(v, cfg.num_rx)
                shard, r_local = divmod(r, rx_per)
                perm.append(shard * cfg.num_tx * rx_per + tx * rx_per + r_local)
            perm = jnp.asarray(perm)

        def finish(power, hits, snaps_fn):
            out = assemble_result(power, snaps_fn, hits, k, cfg)
            if not with_clusters:
                return out
            from mmradar.ops.cluster import cluster_detections

            # per-frame clustering shards trivially over 'data'; under
            # chan-sharding power/hits are already replicated (post-psum)
            return out, cluster_detections(
                power, hits, out.doppler_bin, out.range_bin, out.valid, cfg
            )

        def local_step(shorts_local: jnp.ndarray, base_local: jnp.ndarray):
            # shorts_local: (B_local, S) int16; base_local: (rx_per, C, Smp)
            chan_idx = jax.lax.axis_index(CHAN_AXIS)
            if rd_impl == "fused":
                # interleave-aware DFT matmuls straight off the raw shorts,
                # with this shard's RX group sliced BEFORE the contraction
                # (see ops/fuseddft.py)
                from mmradar.ops.dftmat import resolve_precision
                from mmradar.ops.fuseddft import (
                    base_raw_interleave,
                    doppler_from_range_planes,
                    interleaved_range_matrices,
                )

                a_re, a_im = interleaved_range_matrices(
                    cfg.num_samples, cfg.range_fft_size, cfg.window_kind
                )
                prec = resolve_precision(cfg.dft_precision)
                raw = shorts_local.reshape(
                    shorts_local.shape[:-1]
                    + (cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples)
                ).astype(jnp.float32)
                raw_l = jax.lax.dynamic_slice_in_dim(
                    raw, chan_idx * rx_per, rx_per, axis=2
                )
                mode = cfg.effective_clutter(True)
                if mode == "base":
                    # raw-space base subtraction on THIS shard's RX
                    # slice (the shared convention across every range
                    # path; see fuseddft.base_raw_interleave)
                    raw_l = raw_l - base_raw_interleave(base_local, cfg)
                rng_re = jnp.einsum(
                    "...cvj,rj->...cvr", raw_l, a_re, precision=prec
                )
                rng_im = jnp.einsum(
                    "...cvj,rj->...cvr", raw_l, a_im, precision=prec
                )
                if mode != "base":
                    from mmradar.ops.preproc import declutter_planes

                    rng_re, rng_im = declutter_planes(
                        rng_re, rng_im, mode, None,
                        axis=-3, stride=cfg.num_tx,
                    )
                dr, di = doppler_from_range_planes(rng_re, rng_im, cfg)
                rd_l = None
                planes = (dr, di)
                local_power = jnp.sum(dr * dr + di * di, axis=-3)
            elif rd_impl == "planar":
                # split-plane end-to-end (see RDPipeline._detect_planar)
                from mmradar.ops.decode import decode_to_planes
                from mmradar.ops.dftmat import range_doppler_planes

                from mmradar.models.rd_pipeline import _declutter

                re, im = decode_to_planes(shorts_local, cfg)
                re = _declutter(
                    jax.lax.dynamic_slice_in_dim(
                        re, chan_idx * rx_per, rx_per, axis=1
                    ), base_local.real, cfg,
                )
                im = _declutter(
                    jax.lax.dynamic_slice_in_dim(
                        im, chan_idx * rx_per, rx_per, axis=1
                    ), base_local.imag, cfg,
                )
                dr, di = range_doppler_planes(
                    virtualize_cube(re, cfg), virtualize_cube(im, cfg), cfg
                )
                rd_l = None  # never materialized; snaps gathers per plane
                planes = (dr, di)
                local_power = jnp.sum(dr * dr + di * di, axis=-3)
            else:
                from mmradar.models.rd_pipeline import _declutter

                cube = decode_to_cube(shorts_local, cfg)  # (B, rx, C, Smp)
                cube_l = jax.lax.dynamic_slice_in_dim(
                    cube, chan_idx * rx_per, rx_per, axis=1
                )
                cube_l = virtualize_cube(_declutter(cube_l, base_local, cfg),
                                         cfg)
                if rd_impl == "mxu":
                    from mmradar.ops.dftmat import range_doppler_mxu

                    rd_l = range_doppler_mxu(cube_l, cfg)
                else:
                    rd_l = range_doppler(cube_l, cfg)  # (B, tx*rx_per, D, R)
                planes = None
                local_power = integrate_power(rd_l)
            power = jax.lax.psum(local_power, CHAN_AXIS)
            from mmradar.ops.cfar import cfar_detect

            hits, _ = cfar_detect(power, cfg, hits_only=True)

            def snaps(top_idx):
                if planes is not None:
                    local = jax.lax.complex(
                        gather_snapshots(planes[0], top_idx),
                        gather_snapshots(planes[1], top_idx),
                    )  # (B_l, K, tx*rx_per)
                else:
                    local = gather_snapshots(rd_l, top_idx)
                full = jax.lax.all_gather(
                    local, CHAN_AXIS, axis=local.ndim - 1, tiled=True
                )  # (B_l, K, chan*tx*rx_per) shard-major
                if perm is not None and chan > 1:
                    full = full[..., perm]
                return full

            return finish(power, hits, snaps)

        out_specs = RDResult(
            num_hits=P(DATA_AXIS),
            doppler_bin=P(DATA_AXIS, None),
            range_bin=P(DATA_AXIS, None),
            power=P(DATA_AXIS, None),
            valid=P(DATA_AXIS, None),
            range_m=P(DATA_AXIS, None),
            velocity_mps=P(DATA_AXIS, None),
            azimuth_deg=P(DATA_AXIS, None),
            angle_bin=P(DATA_AXIS, None),
            range_m_interp=P(DATA_AXIS, None),
            velocity_mps_interp=P(DATA_AXIS, None),
        )
        if with_clusters:
            from mmradar.ops.cluster import ClusterResult

            out_specs = (out_specs, ClusterResult(
                cluster_id=P(DATA_AXIS, None),
                num_clusters=P(DATA_AXIS),
                cells=P(DATA_AXIS, None),
                total_power=P(DATA_AXIS, None),
                centroid_range_m=P(DATA_AXIS, None),
                centroid_velocity_mps=P(DATA_AXIS, None),
                extent_doppler_bins=P(DATA_AXIS, None),
                extent_range_bins=P(DATA_AXIS, None),
            ))
        # check_vma=False: the AoA outputs derive from an all_gather over
        # 'chan' (identical on every chan member), but the VMA checker can't
        # infer replication through the gather + argmax chain.
        sharded = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(P(DATA_AXIS, None), P(CHAN_AXIS, None, None)),
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(sharded)

    def _resolve_base(self, base_cube):
        """Allow base-free clutter modes to pass ``base_cube=None``.

        The sharded program's signature always carries a base operand;
        for an EXPLICIT base-free ``clutter_mode`` ('mean'/'mti2'/'mti3',
        which never read it) a zero cube is substituted.  'auto' still
        demands a real base here: resolving it to 'mean' at this level
        while the shard-local dispatch sees a base present would
        silently subtract zeros instead."""
        if base_cube is not None:
            return base_cube
        cfg = self.cfg
        cfg.effective_clutter(False)   # raises for clutter_mode='base'
        if cfg.clutter_mode == "auto":
            raise ValueError(
                "DistributedRDPipeline without a base cube needs an "
                "explicit base-free clutter_mode ('mean', 'mti2' or "
                "'mti3'); 'auto' would silently subtract a zero base"
            )
        zero = jnp.zeros(
            (cfg.num_rx, cfg.num_chirps, cfg.num_samples), jnp.complex64
        )
        return jax.device_put(zero, self.base_sharding)

    def detect(self, shorts, base_cube=None) -> RDResult:
        """Run the sharded pipeline.  Batch must divide the 'data' axis.

        ``base_cube=None`` is accepted for explicit base-free clutter
        modes (see :meth:`_resolve_base`)."""
        return self._detect(shorts, self._resolve_base(base_cube))

    def detect_objects(self, shorts, base_cube):
        """:meth:`detect` plus per-frame object clustering
        (``ops.cluster``): returns ``(RDResult, ClusterResult)``.

        Mirrors ``RDPipeline.detect_objects``: the same sharded program
        plus clustering of its maps, which is embarrassingly
        data-parallel.  Built lazily — callers that never cluster pay
        no extra compile."""
        if not hasattr(self, "_detect_objects"):
            self._detect_objects = self._build_detect(with_clusters=True)
        return self._detect_objects(shorts, self._resolve_base(base_cube))
