"""Live-lane wavefront compaction (SURVEY §7: "wavefront compaction
replaces per-pixel OpenMP loops").

After a few bounce segments a growing fraction of lanes is dead (miss /
Russian roulette / iter budget) but still pays the full intersect+shade
cost: the flagship's live-per-segment profile decays 100% → 60% before the
all-dead tail, and deep/translucent workloads (segment cap 2·depth+2 or
RR-derived, engine/config.suggest_max_segments) spend most segments under
50% occupancy. Compaction reorders lanes so the live ones are a contiguous
prefix; the Pallas intersector then skips whole ray blocks past the live
count (an all-dead block walks no chunks).

Keyed RNG makes this exact: every random draw is keyed by (seed,
state.pixel, sample, stream, slot), all of which travel with the lane —
executed segment-by-segment a compacted render is BIT-IDENTICAL to the
uncompacted one (tests/test_compaction.py pins this). Under one
whole-render jit, XLA's fusion choices on the structurally different
graph may shift lanes by ULPs, exactly as changing unroll/remat does.

The state is ~17 [N]-rows, so the permutation is pure data movement.
Two formulations:

  * "sort": one stable variadic `lax.sort` keyed by the dead flag
    co-sorts every state column in a single fused op;
  * "gather": compute the permutation with one small sort over (flag,
    iota), then `x[perm]` every column (XLA fuses the gathers).

Both are shape-static and jit-safe. Which wins, and whether compaction
pays at all on the GPU, is not measured yet (ROADMAP S2/S4); the
integrator takes cfg.compact_wavefront ∈ {"off", "sort", "gather"}.

Integer payloads ride the sort as their own operands (no float packing),
so pixel ids are exact at any resolution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _spread3(x):
    """Interleave 8-bit x into every 3rd bit (Morton spread, i32)."""
    x = x & 0xFF
    x = (x | (x << 8)) & 0x00F00F
    x = (x | (x << 4)) & 0x0C30C3
    x = (x | (x << 2)) & 0x249249
    return x


def coherence_key(state, scene):
    """i32 lane key: dead lanes last; live lanes by (direction octant,
    origin Morton). Sorting the wavefront by this key each segment packs
    dead lanes into all-dead ray blocks (which the Pallas kernel skips)
    AND restores spatial coherence for bounce rays, so a block's rays
    enable fewer triangle chunks. The per-segment state sort amortizes
    across the bounce + shadow + opacity queries of the segment.

    The scene bbox reductions are loop-invariant (scene is constant
    across segments); XLA hoists them out of the segment scan.
    """
    g = scene.geom
    lo = jnp.min(jnp.minimum(jnp.minimum(g.v0, g.v0 + g.e1),
                             g.v0 + g.e2), axis=0)
    hi = jnp.max(jnp.maximum(jnp.maximum(g.v0, g.v0 + g.e1),
                             g.v0 + g.e2), axis=0)
    rd, ro = state.rd, state.ro
    oct_ = ((rd[:, 0] > 0).astype(jnp.int32)
            | ((rd[:, 1] > 0).astype(jnp.int32) << 1)
            | ((rd[:, 2] > 0).astype(jnp.int32) << 2))
    scale = 255.0 / jnp.maximum(hi - lo, 1e-6)
    q = jnp.clip((ro - lo) * scale, 0.0, 255.0).astype(jnp.int32)
    morton = ((_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1)
              | _spread3(q[:, 2]))
    key = (oct_ << 24) | morton
    return jnp.where(state.alive, key, jnp.int32(2 ** 31 - 1))


def _state_columns(state, slot):
    """Flatten (state, slot) into a list of [N] / [N,3] arrays + rebuild."""
    cols = [state.ro, state.rd, state.throughput, state.radiance,
            state.alive, state.inside, state.itr, state.depth, state.pixel,
            slot]

    def rebuild(vals):
        (ro, rd, tp, rad, alive, inside, itr, depth, pixel, slot) = vals
        return state.replace(ro=ro, rd=rd, throughput=tp, radiance=rad,
                             alive=alive, inside=inside, itr=itr,
                             depth=depth, pixel=pixel), slot
    return cols, rebuild


def compact_sort(state, slot, key=None):
    """Stable variadic sort by ``key`` (default: the dead flag — live
    lanes first; pass coherence_key(state, scene) for the octant/Morton
    layout). Returns (state, slot, n_live)."""
    cols, rebuild = _state_columns(state, slot)
    if key is None:
        key = (~state.alive).astype(jnp.int32)
    n_live = jnp.sum(state.alive.astype(jnp.int32))
    # lax.sort co-sorts operands; 2-D columns sort along axis 0 only if
    # given per-column — split [N,3] into scalars to keep one variadic op.
    flat = []
    splits = []
    for c in cols:
        if c.ndim == 2:
            for j in range(c.shape[1]):
                flat.append(c[:, j])
            splits.append(c.shape[1])
        else:
            flat.append(c)
            splits.append(0)
    out = jax.lax.sort((key, *flat), num_keys=1, is_stable=True)[1:]
    vals = []
    it = iter(out)
    for c, s in zip(cols, splits):
        if s:
            vals.append(jnp.stack([next(it) for _ in range(s)], axis=1))
        else:
            vals.append(next(it))
    st, sl = rebuild(vals)
    return st, sl, n_live


def compact_gather(state, slot, key=None):
    """Permutation via (key, iota) sort + per-column gathers."""
    if key is None:
        key = (~state.alive).astype(jnp.int32)
    n_live = jnp.sum(state.alive.astype(jnp.int32))
    iota = jnp.arange(key.shape[0], dtype=jnp.int32)
    _, perm = jax.lax.sort((key, iota), num_keys=1, is_stable=True)
    cols, rebuild = _state_columns(state, slot)
    st, sl = rebuild([c[perm] for c in cols])
    return st, sl, n_live


def scatter_to_slots(values, slot):
    """Undo the lane reordering: values[i] lands at its original lane
    ``slot[i]`` (slots are a permutation of arange)."""
    out = jnp.zeros_like(values)
    return out.at[slot].set(values)
