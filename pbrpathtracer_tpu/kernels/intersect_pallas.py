"""Fused closest-hit kernel with chunk culling (Pallas, Triton route).

The plain GPU route, ``intersect_matmul`` (ops/intersect.py), writes an
[N, 4·chunk] fp32 test matrix to device memory for every triangle chunk
and reads it back for the acceptance tests; at 1024×768 rays that is
about 1.6 GB of traffic per query, and its K = 10 product gives the
tensor cores nothing to do. This kernel keeps all of it in registers:

  * one program per block of ``BLOCK_RAYS`` rays, one ray per thread;
    the running best (t, u, v, id) lives in registers for the whole
    query and is written once;
  * triangles are grouped in chunks of ``CHUNK`` with a precomputed AABB
    (in BVH depth-first order when the scene has a BVH, so a chunk is a
    tight spatial cluster). A ``fori_loop`` walks the chunks; each ray
    slab-tests the chunk box against its current best t, and the block
    skips the chunk when no live lane can hit it - the per-chunk skip
    XLA cannot express;
  * surviving chunks run classic Möller–Trumbore (pathtracer.cpp:373-409
    operation order) one triangle at a time: nine scalar loads shared by
    the block, the arithmetic vectorized over its rays;
  * dead lanes (``alive`` False) never enable a chunk and report a clean
    miss (ops/intersect.mask_dead contract); an all-dead block skips the
    walk entirely.

Ties between equal t resolve to the earliest triangle in walk order (the
jnp intersectors' ``argmin`` order when no BVH permutation applies).

The kernel compiles for the GPU only. ``interpret=True`` runs it on the
CPU through the Pallas interpreter; only tests turn that on.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..utils.constants import EPS

BIG = np.float32(3.0e38)
BLOCK_RAYS = 128   # rays per program (one per thread at NUM_WARPS=4)
NUM_WARPS = 4
CHUNK = 16         # triangles per culling box
TINY = np.float32(1e-30)
# Columns of the [T, TRI_COLS] triangle table: v0(3), e1(3), e2(3), then
# padding so each triangle's row is one aligned 64-byte line.
TRI_COLS = 16


def _kernel(n_chunks, chunk, r_ref, w_ref, box_ref,
            ot_ref, ou_ref, ov_ref, oi_ref):
    rdx, rdy, rdz = r_ref[0, :], r_ref[1, :], r_ref[2, :]
    rox, roy, roz = r_ref[3, :], r_ref[4, :], r_ref[5, :]
    t_lower = r_ref[6, :]
    alive = r_ref[7, :] > 0.0

    # NaN-robust slabs: clamping |rd| >= TINY keeps (bound - ro) / rd
    # finite-or-inf (never 0·inf) with identical accept/reject decisions.
    def inv(d):
        return 1.0 / jnp.where(jnp.abs(d) < TINY,
                               jnp.where(d < 0.0, -TINY, TINY), d)
    ix, iy, iz = inv(rdx), inv(rdy), inv(rdz)

    def tri_body(c, can_hit, k, best):
        bt, bu, bv, bi = best
        j = c * chunk + k
        v0x, v0y, v0z = w_ref[j, 0], w_ref[j, 1], w_ref[j, 2]
        e1x, e1y, e1z = w_ref[j, 3], w_ref[j, 4], w_ref[j, 5]
        e2x, e2y, e2z = w_ref[j, 6], w_ref[j, 7], w_ref[j, 8]
        hx = rdy * e2z - rdz * e2y
        hy = rdz * e2x - rdx * e2z
        hz = rdx * e2y - rdy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        sx, sy, sz = rox - v0x, roy - v0y, roz - v0z
        u_num = sx * hx + sy * hy + sz * hz
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v_num = rdx * qx + rdy * qy + rdz * qz
        t_num = e2x * qx + e2y * qy + e2z * qz
        denom_ok = jnp.abs(a) >= EPS
        f = jnp.where(denom_ok, 1.0 / jnp.where(denom_ok, a, 1.0), 0.0)
        u = u_num * f
        v = v_num * f
        t = t_num * f
        take = (denom_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                & (u + v <= 1.0) & (t > EPS) & (t > t_lower) & can_hit
                & (t < bt))
        return (jnp.where(take, t, bt), jnp.where(take, u, bu),
                jnp.where(take, v, bv), jnp.where(take, j, bi))

    def chunk_body(c, best):
        t1x = (box_ref[c, 0] - rox) * ix
        t1y = (box_ref[c, 1] - roy) * iy
        t1z = (box_ref[c, 2] - roz) * iz
        t2x = (box_ref[c, 4] - rox) * ix
        t2y = (box_ref[c, 5] - roy) * iy
        t2z = (box_ref[c, 6] - roz) * iz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                     jnp.minimum(t1y, t2y)),
                         jnp.minimum(t1z, t2z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                     jnp.maximum(t1y, t2y)),
                         jnp.maximum(t1z, t2z))
        can_hit = (tn < tf) & (tf > 0.0) & (tn < best[0]) & alive
        any_hit = jnp.max(can_hit.astype(jnp.int32)) > 0
        return jax.lax.cond(
            any_hit,
            lambda b: jax.lax.fori_loop(
                0, chunk, functools.partial(tri_body, c, can_hit), b),
            lambda b: b, best)

    best = (jnp.full_like(rdx, BIG), jnp.zeros_like(rdx),
            jnp.zeros_like(rdx), jnp.zeros(rdx.shape, jnp.int32))
    any_alive = jnp.max(alive.astype(jnp.int32)) > 0
    bt, bu, bv, bi = jax.lax.cond(
        any_alive,
        lambda b: jax.lax.fori_loop(0, n_chunks, chunk_body, b),
        lambda b: b, best)
    ot_ref[:] = bt
    ou_ref[:] = bu
    ov_ref[:] = bv
    oi_ref[:] = bi


def _run(R, W, boxes, chunk, block_rays, num_warps, interpret):
    n_pad = R.shape[1]
    n_chunks = boxes.shape[0]
    row = pl.BlockSpec((block_rays,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_kernel, n_chunks, chunk),
        grid=(n_pad // block_rays,),
        in_specs=[pl.BlockSpec((8, block_rays), lambda i: (0, i)),
                  pl.BlockSpec(W.shape, lambda i: (0, 0)),
                  pl.BlockSpec(boxes.shape, lambda i: (0, 0))],
        out_specs=[row, row, row, row],
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((n_pad,), jnp.int32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="intersect_closest_hit",
    )(R, W, boxes)


def chunk_tables(v0, e1, e2, chunk=CHUNK):
    """[t_pad, TRI_COLS] triangle table and [n_chunks, 8] chunk boxes
    (lo xyz, 0, hi xyz, 0). Padded triangles have zero edges (|a| < EPS
    → miss); padded slots get inverted bounds so they never enable a
    chunk by themselves."""
    T = v0.shape[0]
    t_pad = max(((T + chunk - 1) // chunk) * chunk, chunk)
    n_chunks = t_pad // chunk
    W = jnp.pad(jnp.concatenate([v0, e1, e2], axis=1),
                ((0, t_pad - T), (0, TRI_COLS - 9)))
    lo = jnp.minimum(jnp.minimum(v0, v0 + e1), v0 + e2)
    hi = jnp.maximum(jnp.maximum(v0, v0 + e1), v0 + e2)
    lo = jnp.concatenate([lo, jnp.full((t_pad - T, 3), BIG)], axis=0)
    hi = jnp.concatenate([hi, jnp.full((t_pad - T, 3), -BIG)], axis=0)
    # Inflate by EPS: the strict slab test (tn < tf) would cull an exactly
    # flat box (an axis-aligned quad has lo == hi on one axis). The
    # reference inflates degenerate AABBs the same way (AABB::Check,
    # mesh.cpp:32-45); inflation only makes culling conservative.
    c_lo = jnp.min(lo.reshape(n_chunks, chunk, 3), axis=1) - EPS
    c_hi = jnp.max(hi.reshape(n_chunks, chunk, 3), axis=1) + EPS
    z = jnp.zeros((n_chunks, 1), jnp.float32)
    boxes = jnp.concatenate([c_lo, z, c_hi, z], axis=1)
    return W, boxes


def intersect_pallas(geom_or_scene, ro, rd, t_lower=None, alive=None,
                     interpret: bool = False):
    """Closest-hit query with the ops.intersect contract: returns (hit
    bool[N], tri_idx i32[N], t f32[N], u f32[N], v f32[N]).

    Accepts a Scene (walks chunks in ``scene.accel.perm`` order when it
    has a BVH) or a bare Geometry.
    """
    return _query(geom_or_scene, ro, rd, t_lower, alive, interpret,
                  CHUNK, BLOCK_RAYS, NUM_WARPS)


def _query(geom_or_scene, ro, rd, t_lower, alive, interpret, chunk,
           block_rays, num_warps):
    """intersect_pallas with an explicit tiling (powers of two)."""
    geom = getattr(geom_or_scene, "geom", geom_or_scene)
    accel = getattr(geom_or_scene, "accel", None)
    perm = None if accel is None else accel.perm
    N = ro.shape[0]
    if t_lower is None:
        t_lower = jnp.zeros((N,), jnp.float32)
    alive_f = (jnp.ones((N,), jnp.float32) if alive is None
               else alive.astype(jnp.float32))
    v0, e1, e2 = geom.v0, geom.e1, geom.e2
    if perm is not None:
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
    W, boxes = chunk_tables(v0, e1, e2, chunk)

    n_pad = ((N + block_rays - 1) // block_rays) * block_rays
    R = jnp.stack([rd[:, 0], rd[:, 1], rd[:, 2], ro[:, 0], ro[:, 1],
                   ro[:, 2], t_lower, alive_f])
    R = jnp.pad(R, ((0, 0), (0, n_pad - N)))    # pad lanes: alive 0 = dead
    t, u, v, i = _run(R, W, boxes, chunk, block_rays, num_warps, interpret)
    t, u, v, i = t[:N], u[:N], v[:N], i[:N]
    hit = t < BIG
    i = jnp.where(hit, i, 0)
    if perm is not None:
        i = perm[i]                                  # back to scene ids
    z = jnp.float32(0.0)
    return (hit, jnp.where(hit, i, 0), jnp.where(hit, t, z),
            jnp.where(hit, u, z), jnp.where(hit, v, z))
