"""Clutter-map (Nitzberg) CFAR: per-cell recursive background over frames.

Spatial CFAR estimates each cell's noise from its NEIGHBORS — wrong
wherever the clutter floor varies across the map (rain cells, ground
patches, floor steps: CA's training ring mixes the two levels, masking
targets on the high side and false-alarming near the edge).  The
clutter map instead keeps a per-cell recursive average over FRAMES,
updated once per BLOCK with the block mean:
``m <- (1-beta) m + beta mean(block)``, decision
``p > alpha * m`` against the pre-update map.

The block discipline is the load-bearing design point, found by
measurement: classic clutter maps update at SCAN cadence, and at
per-CPI frame rates (8 ms) a per-frame EMA absorbs even a moving
target — a 3 m/s target dwells ~16 frames in one 0.39 m range cell and
vanished after ONE frame at beta=0.25.  With ``block`` at least the
cell dwell, a mover crosses cells between map updates and never
self-masks, while the floor adaptation is unaffected.

The alpha is exact for iid exponential cells
(``golden.clutter_map_alpha``:
``Pfa = prod_i (1 + alpha beta (1-beta)^i / s)^{-s}``, s = block;
Monte-Carlo validated at 1.03e-3 measured vs 1e-3 configured) and for
Erlang-N cells via ``n_pulses`` (the MGF-derivative series in
``golden.clutter_map_alpha`` — RX-summed power maps pass
``cfg.cfar_pulses_effective`` exactly like every spatial kind).

Device shape: detection is one vectorized compare per block (no per-frame
recursion), the update one mean + two elementwise passes — a
``lax.scan`` over BLOCKS, so the sequential chain is F/block steps.
The state is explicit (pass ``m0``, get the final map back), which is
what the live serving loop needs to carry its background across
micro-batches (there each dispatch is one block).

Reference contrast: the reference has one detector (argmax,
acceleration.cu:522) and no notion of a varying clutter floor.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mmradar.config import DEFAULT_CONFIG


@functools.lru_cache(maxsize=None)
def _alpha(pfa: float, beta: float, block: int, n_pulses: int) -> float:
    from mmradar.golden import clutter_map_alpha

    return clutter_map_alpha(pfa, beta, block, n_pulses)


@functools.partial(
    jax.jit, static_argnames=("pfa", "beta", "seeded", "block", "n_pulses")
)
def clutter_map_cfar(
    power: jnp.ndarray,
    pfa: float = DEFAULT_CONFIG.cfar_pfa,
    beta: float = 0.25,
    m0: jnp.ndarray | None = None,
    seeded: bool = False,
    block: int = 16,
    n_pulses: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run the block-updated clutter-map detector over a frame batch.

    Args:
      power: float32 (frames, doppler, range) power maps.
      m0: optional (doppler, range) background to continue from (a
        previous call's returned map).  Required when ``seeded=True``;
        the seeded form treats THIS CALL as one block: every frame
        detects against ``m0`` and the map updates once with the batch
        mean (the serving discipline — the block-alpha then describes
        steady state for batches of ~``block`` frames).
      seeded: static flag selecting the two-arg form vs self-seeding
        (first ``block`` frames seed the map and emit no hits).
      block: frames per map update; choose >= the slowest target's
        cell dwell (``cell_size / (v * frame_interval)``).

    Returns:
      (hits bool (frames, d, r), m_out float32 (d, r)).
    """
    alpha = _alpha(float(pfa), float(beta), int(block), int(n_pulses))
    f_total = power.shape[0]
    if seeded:
        if m0 is None:
            raise ValueError("seeded=True requires m0")
        m = m0.astype(jnp.float32)
        hits = power > alpha * m
        m_out = (1.0 - beta) * m + beta * power.mean(axis=0)
        return hits, m_out

    n_seed = min(block, f_total)
    m = power[:n_seed].mean(axis=0)
    hits0 = jnp.zeros(power[:n_seed].shape, bool)
    rest = power[n_seed:]
    n_rest = rest.shape[0]
    n_full = n_rest // block
    tail = rest[n_full * block :]

    def step(m, blk):
        h = blk > alpha * m
        return (1.0 - beta) * m + beta * blk.mean(axis=0), h

    parts = [hits0]
    if n_full:
        m, h_full = jax.lax.scan(
            step, m, rest[: n_full * block].reshape(
                (n_full, block) + rest.shape[1:]
            ),
        )
        parts.append(h_full.reshape((n_full * block,) + rest.shape[1:]))
    if tail.shape[0]:
        m, h_tail = step(m, tail)
        parts.append(h_tail)
    return jnp.concatenate(parts, axis=0), m
