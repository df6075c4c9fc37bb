"""Stackless BVH traversal in JAX.

Per-lane cursor walk over the escape-linked flat layout (accel/build.py):
`lax.while_loop` carrying (cursor, best hit) per ray, vmapped over the
wavefront. The slab test adds the ``tFar > 0`` and ``tNear < best_t``
prunes the reference omits (mesh.cpp:48-59) — traversal-order-only
optimizations; closest-hit results are unchanged because hits are compared
by distance, and stochastic-opacity draws are keyed per attempt, not per
visited node (ops/rng.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.constants import EPS
from .build import FlatBVH

# A numpy scalar, not a jax Array: a module-level device array closed over
# by traced code becomes a hoisted executable argument, which the jit fast
# path then fails to pass ("Execution supplied N buffers but compiled
# program expected N+k").
BIG = np.float32(3.0e38)


def _traverse_one(bvh_arrays, tris, leaf_size, ro, rd, t_lower, start):
    """Closest hit for ONE ray (designed to be vmapped). ``start`` is the
    initial cursor: 0 walks the tree, M (node count) is a zero-length walk
    (dead lanes)."""
    bmin, bmax, first, count, escape, perm = bvh_arrays
    v0, e1, e2 = tris
    M = first.shape[0]
    # NaN-robust slabs: clamp |rd| >= TINY so (bound-ro)*inv_rd is never
    # 0*inf = NaN (rd==0 with the origin exactly on a node plane would
    # propagate NaN through min/max and wrongly cull the node).
    TINY = np.float32(1e-30)
    rd_safe = jnp.where(jnp.abs(rd) < TINY,
                        jnp.where(rd < 0.0, -TINY, TINY), rd)
    inv_rd = 1.0 / rd_safe

    def cond(c):
        return c[0] < M

    def body(c):
        ptr, bt, bi, bu, bv = c
        nmin = bmin[ptr]
        nmax = bmax[ptr]
        t1 = (nmin - ro) * inv_rd
        t2 = (nmax - ro) * inv_rd
        tnear = jnp.max(jnp.minimum(t1, t2))
        tfar = jnp.min(jnp.maximum(t1, t2))
        hit_box = (tnear < tfar) & (tfar > 0.0) & (tnear < bt)

        cnt = count[ptr]
        is_leaf = cnt > 0

        # Leaf test, straight-line + masked (under vmap a lax.cond becomes a
        # both-branches select anyway, and cond-inside-while breaks the
        # outer integrator cond's MLIR lowering under grad).
        active = hit_box & is_leaf
        f0 = first[ptr]
        slots = f0 + jnp.arange(leaf_size, dtype=jnp.int32)
        valid_slot = (jnp.arange(leaf_size) < cnt) & active
        tri = perm[jnp.clip(slots, 0, perm.shape[0] - 1)]
        tri_safe = jnp.clip(tri, 0, v0.shape[0] - 1)
        tv0 = v0[tri_safe]
        te1 = e1[tri_safe]
        te2 = e2[tri_safe]
        # Möller–Trumbore (pathtracer.cpp:373-409 semantics)
        h = jnp.cross(jnp.broadcast_to(rd, te2.shape), te2)
        a = jnp.sum(te1 * h, axis=-1)
        ok = jnp.abs(a) >= EPS
        f = jnp.where(ok, 1.0 / jnp.where(ok, a, 1.0), 0.0)
        s = ro - tv0
        u = f * jnp.sum(s * h, axis=-1)
        q = jnp.cross(s, te1)
        v = f * jnp.sum(rd[None, :] * q, axis=-1)
        t = f * jnp.sum(te2 * q, axis=-1)
        valid = (ok & valid_slot & (tri >= 0)
                 & (u >= 0.0) & (u <= 1.0)
                 & (v >= 0.0) & (u + v <= 1.0)
                 & (t > EPS) & (t > t_lower) & (t < bt))
        t_m = jnp.where(valid, t, BIG)
        j = jnp.argmin(t_m)
        better = t_m[j] < bt
        bt = jnp.where(better, t_m[j], bt)
        bi = jnp.where(better, tri[j], bi)
        bu = jnp.where(better, u[j], bu)
        bv = jnp.where(better, v[j], bv)

        ptr = jnp.where(hit_box, ptr + 1, escape[ptr])
        return (ptr, bt, bi, bu, bv)

    init = (start, BIG, jnp.int32(0), jnp.float32(0), jnp.float32(0))
    _, bt, bi, bu, bv = jax.lax.while_loop(cond, body, init)
    hit = bt < BIG
    return hit, bi, jnp.where(hit, bt, 0.0), bu, bv


def intersect_bvh(scene, ro, rd, t_lower=None, leaf_size=None, alive=None):
    """Closest-hit query through scene.accel. Same contract as the dense
    intersectors (ops/intersect.py). Dead lanes (``alive`` False) start at
    the end cursor (node count M) — a zero-length walk — and report a
    clean miss."""
    bvh: FlatBVH = scene.accel
    assert bvh is not None, "scene has no BVH; build with with_accel()"
    if t_lower is None:
        t_lower = jnp.zeros((ro.shape[0],), jnp.float32)
    if leaf_size is None:
        leaf_size = bvh.leaf_size   # static pytree metadata
    g = scene.geom
    # pad perm so leaf gathers never clip into a neighbouring leaf
    perm = jnp.concatenate([
        bvh.perm, jnp.full((leaf_size,), -1, jnp.int32)])
    arrays = (bvh.bounds_min, bvh.bounds_max, bvh.first, bvh.count,
              bvh.escape, perm)
    tris = (g.v0, g.e1, g.e2)
    M = bvh.first.shape[0]
    if alive is None:
        start = jnp.zeros((ro.shape[0],), jnp.int32)
    else:
        # dead lanes start at the end cursor: a zero-length walk
        start = jnp.where(alive, 0, M).astype(jnp.int32)
    out = jax.vmap(
        lambda o, d, tl, st: _traverse_one(arrays, tris, leaf_size, o, d,
                                           tl, st)
    )(ro, rd, t_lower, start)
    from ..ops.intersect import mask_dead
    return mask_dead(alive, *out)
