"""Ray-triangle intersection: the plain-JAX closest-hit queries.

The reference walks a pointer-based BVH recursively and runs scalar
Möller–Trumbore per leaf (pathtracer.cpp:373-492). This module provides two
dense formulations over (ray, triangle) tiles:

1. ``intersect_classic`` — vectorized Möller–Trumbore, elementwise.
   Reference-faithful operation order; the parity baseline and the
   reference the Pallas kernel (kernels/intersect_pallas.py) is tested
   against.

2. ``intersect_matmul`` — every Möller–Trumbore determinant is *bilinear*
   in (ray features) × (triangle features), so the four quantities
   (det a, u·a, v·a, t·a) for all N×T pairs are ONE matmul

       [N, 10] @ [10, 4T]  →  [N, 4, T]

   with ray features R = [rd, ro×rd, ro, 1] and per-triangle weight columns
   derived from (v0, e1, e2):

       a_det = rd·(e2×e1)                                  (MT denominator)
       u·a   = (ro×rd)·e2 − rd·(e2×v0)
       v·a   = −(ro×rd)·e1 + rd·(e1×v0)
       t·a   = ro·(e1×e2) − v0·(e1×e2)

   It needs no gather, no traversal stack and no divergence. Hit tests
   divide by ``a`` afterward (sign-correct for both u,v,t since they share
   the 1/a factor). The product runs at ``Precision.HIGHEST``: in TF32 or
   bf16 the hit distances would lose ~1e-3 of t.

Both are chunked over triangles with a `lax.scan` running-min so peak memory
is O(N × chunk). On the GPU, ``ops/hit.py`` routes small scenes to the Pallas
kernel and large ones to the BVH walk in ``accel/``; these two remain the
route on other backends and the references for tests.

Acceptance tests (match pathtracer.cpp:387-408): |a| ≥ EPS, 0 ≤ u ≤ 1,
v ≥ 0, u + v ≤ 1, t > EPS. ``t_lower`` additionally excludes hits at or
before a given distance — used to re-trace past stochastically-transparent
hits (Hit's alpha rejection, pathtracer.cpp:469-476).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.constants import EPS
from ..scene.scene import Geometry

BIG = np.float32(3.0e38)

# Per-chunk intermediate budget (f32 elements) for the N×(4·chunk) test
# matrix: bounds peak HBM regardless of wavefront size. 64M f32 = 256 MB.
CHUNK_ELEM_BUDGET = 64 * 1024 * 1024


def _auto_chunk(n_rays: int, n_tris: int, requested: int) -> int:
    """Pick a triangle-chunk size: fit the [N, 4*chunk] intermediate inside
    the budget, round to a multiple of 128, never exceed `requested`."""
    fit = max(CHUNK_ELEM_BUDGET // max(4 * n_rays, 1), 128)
    chunk = min(requested, fit)
    chunk = max(128, (chunk // 128) * 128)
    # No point chunking past the (padded) triangle count.
    t_pad = ((n_tris + 127) // 128) * 128
    return min(chunk, max(t_pad, 128))


def _pad_tris(arrs, chunk):
    """Pad T-dim arrays to a multiple of chunk with degenerate (auto-miss)
    triangles (zero edges → a = 0 → |a| < EPS → miss)."""
    T = arrs[0].shape[0]
    Tp = ((T + chunk - 1) // chunk) * chunk
    if Tp == T:
        return arrs, T
    pad = Tp - T
    return [jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)) for a in arrs], T


def triangle_features(geom: Geometry) -> jnp.ndarray:
    """Precompute the [10, 4, T] weight tensor for ``intersect_matmul``."""
    v0, e1, e2 = geom.v0, geom.e1, geom.e2
    e2xe1 = jnp.cross(e2, e1)
    e2xv0 = jnp.cross(e2, v0)
    e1xv0 = jnp.cross(e1, v0)
    e1xe2 = jnp.cross(e1, e2)
    t_const = -jnp.sum(v0 * e1xe2, axis=-1)
    T = v0.shape[0]
    z3 = jnp.zeros((T, 3), jnp.float32)
    z1 = jnp.zeros((T,), jnp.float32)
    # Rows: rd (3), ro×rd (3), ro (3), 1 (1)  →  10 features.
    # Columns per quantity: [a, u·a, v·a, t·a]
    W = jnp.stack([
        jnp.concatenate([e2xe1, z3, z3, z1[:, None]], axis=-1),       # a
        jnp.concatenate([-e2xv0, e2, z3, z1[:, None]], axis=-1),      # u·a
        jnp.concatenate([e1xv0, -e1, z3, z1[:, None]], axis=-1),      # v·a
        jnp.concatenate([z3, z3, e1xe2, t_const[:, None]], axis=-1),  # t·a
    ], axis=1)                                                        # [T, 4, 10]
    return jnp.transpose(W, (2, 1, 0))                                # [10, 4, T]


def ray_features(ro, rd) -> jnp.ndarray:
    """[N, 10] ray feature matrix for ``intersect_matmul``."""
    ones = jnp.ones((ro.shape[0], 1), jnp.float32)
    return jnp.concatenate([rd, jnp.cross(ro, rd), ro, ones], axis=-1)


def _hit_tests(a, u_num, v_num, t_num, t_lower):
    """Shared acceptance logic; returns (t_masked, u, v) with misses at BIG."""
    denom_ok = jnp.abs(a) >= EPS
    f = jnp.where(denom_ok, 1.0 / jnp.where(denom_ok, a, 1.0), 0.0)
    u = u_num * f
    v = v_num * f
    t = t_num * f
    valid = (denom_ok
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t > EPS) & (t > t_lower[:, None]))
    return jnp.where(valid, t, BIG), u, v


def _running_best(carry, t_masked, u, v, base_idx):
    """Fold a [N, C] chunk result into the (t, idx, u, v) running best."""
    best_t, best_i, best_u, best_v = carry
    c_arg = jnp.argmin(t_masked, axis=-1)                      # [N]
    n_idx = jnp.arange(t_masked.shape[0])
    c_t = t_masked[n_idx, c_arg]
    c_u = u[n_idx, c_arg]
    c_v = v[n_idx, c_arg]
    take = c_t < best_t
    return (jnp.where(take, c_t, best_t),
            jnp.where(take, base_idx + c_arg.astype(jnp.int32), best_i),
            jnp.where(take, c_u, best_u),
            jnp.where(take, c_v, best_v))


def mask_dead(alive, hit, idx, t, u, v):
    """Dead-lane contract shared by every intersector: lanes with
    ``alive == False`` report a clean miss (hit False, idx/t/u/v zero) —
    identical to what the Pallas kernel's alive-gated cull produces from
    its initialized accumulators. Live lanes are untouched (bit-exact).
    """
    if alive is None:
        return hit, idx, t, u, v
    z = jnp.float32(0.0)
    return (hit & alive, jnp.where(alive, idx, 0), jnp.where(alive, t, z),
            jnp.where(alive, u, z), jnp.where(alive, v, z))


def intersect_matmul(geom: Geometry, ro, rd, t_lower=None, chunk: int = 2048,
                     tri_w: jnp.ndarray | None = None, alive=None):
    """Closest-hit query via the bilinear matmul formulation.

    Returns (hit bool[N], tri_idx i32[N], t f32[N], u f32[N], v f32[N]).
    ``alive`` optionally masks lanes to a clean miss (see mask_dead).
    """
    N = ro.shape[0]
    if t_lower is None:
        t_lower = jnp.zeros((N,), jnp.float32)
    if tri_w is None:
        tri_w = triangle_features(geom)
    chunk = _auto_chunk(N, tri_w.shape[-1], chunk)
    (tri_w,), T = _pad_tris([jnp.moveaxis(tri_w, -1, 0)], chunk)
    tri_w = jnp.moveaxis(tri_w, 0, -1)            # [10, 4, Tp]
    n_chunks = tri_w.shape[-1] // chunk
    R = ray_features(ro, rd)                      # [N, 10]

    chunks = jnp.transpose(
        tri_w.reshape(10, 4, n_chunks, chunk), (2, 0, 1, 3))  # [n, 10, 4, C]

    def body(carry, xs):
        Wc, base = xs
        # HIGHEST precision: a reduced-precision product (bf16 or TF32)
        # loses ~1e-3 of t — geometrically catastrophic. Full f32 keeps hit
        # distances within f32 noise of the classic formulation.
        out = jnp.dot(R, Wc.reshape(10, 4 * chunk),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST).reshape(N, 4, chunk)
        a, u_num, v_num, t_num = out[:, 0], out[:, 1], out[:, 2], out[:, 3]
        t_masked, u, v = _hit_tests(a, u_num, v_num, t_num, t_lower)
        return _running_best(carry, t_masked, u, v, base), None

    init = (jnp.full((N,), BIG), jnp.zeros((N,), jnp.int32),
            jnp.zeros((N,)), jnp.zeros((N,)))
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (best_t, best_i, best_u, best_v), _ = jax.lax.scan(body, init, (chunks, bases))
    hit = best_t < BIG
    return mask_dead(alive, hit, best_i, jnp.where(hit, best_t, 0.0),
                     best_u, best_v)


def intersect_classic(geom: Geometry, ro, rd, t_lower=None, chunk: int = 2048,
                      alive=None):
    """Closest-hit query via vectorized classic Möller–Trumbore
    (pathtracer.cpp:373-409 operation order). Elementwise; parity
    baseline."""
    N = ro.shape[0]
    if t_lower is None:
        t_lower = jnp.zeros((N,), jnp.float32)
    chunk = _auto_chunk(N, geom.v0.shape[0], chunk)
    (v0, e1, e2), T = _pad_tris([geom.v0, geom.e1, geom.e2], chunk)
    n_chunks = v0.shape[0] // chunk

    v0c = v0.reshape(n_chunks, chunk, 3)
    e1c = e1.reshape(n_chunks, chunk, 3)
    e2c = e2.reshape(n_chunks, chunk, 3)

    def body(carry, xs):
        cv0, ce1, ce2, base = xs
        # [N, C, 3] broadcasts
        h = jnp.cross(rd[:, None, :], ce2[None, :, :])
        a = jnp.sum(ce1[None] * h, axis=-1)
        s = ro[:, None, :] - cv0[None]
        u_num = jnp.sum(s * h, axis=-1)
        q = jnp.cross(s, ce1[None])
        v_num = jnp.sum(rd[:, None, :] * q, axis=-1)
        t_num = jnp.sum(ce2[None] * q, axis=-1)
        t_masked, u, v = _hit_tests(a, u_num, v_num, t_num, t_lower)
        return _running_best(carry, t_masked, u, v, base), None

    init = (jnp.full((N,), BIG), jnp.zeros((N,), jnp.int32),
            jnp.zeros((N,)), jnp.zeros((N,)))
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (best_t, best_i, best_u, best_v), _ = jax.lax.scan(
        body, init, (v0c, e1c, e2c, bases))
    hit = best_t < BIG
    return mask_dead(alive, hit, best_i, jnp.where(hit, best_t, 0.0),
                     best_u, best_v)
