"""Custom VJP for closest-hit queries.

Differentiating the intersector by autodiff replays the *entire* N×T (or
BVH-walk) computation backward — and `lax.while_loop` (the BVH path) has no
reverse rule at all. But the closest hit is locally a function of just the
winning triangle: with the hit index fixed (the discrete argmin detaches,
matching the pathwise estimator used everywhere else), t/u/v are closed-form
Möller–Trumbore ratios of (ro, rd) against that one triangle. So:

  forward  = any intersector (dense matmul, classic, BVH walk, Pallas)
  backward = recompute (t, u, v) for the winner by gather and differentiate
             THAT (O(N) instead of O(N·T))

Cotangents flow to (ro, rd) only — the camera/lens and bounce-direction
chains need exactly that; scene geometry is a static leaf and t_lower only
shifts the discrete selection, so both get ``None`` (zero) cotangents.
Residuals hold plain arrays, never the scene pytree — pytree residuals with
mixed static metadata leaked tracers as jaxpr constants under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.constants import EPS


def with_custom_vjp(intersect_fn):
    """Wrap ``intersect_fn(scene, ro, rd, t_lower, alive=None)`` with the
    winner-only VJP. The returned callable has the same signature/contract
    (``alive`` is a discrete mask — no cotangent)."""

    @jax.custom_vjp
    def run(scene, ro, rd, t_lower, alive):
        return intersect_fn(scene, ro, rd, t_lower, alive=alive)

    def fwd(scene, ro, rd, t_lower, alive):
        out = intersect_fn(scene, ro, rd, t_lower, alive=alive)
        hit, idx, _, _, _ = out
        return out, (scene.geom.v0, scene.geom.e1, scene.geom.e2,
                     hit, idx, ro, rd)

    def bwd(res, cot):
        v0g, e1g, e2g, hit, idx, ro, rd = res
        _, _, ct, cu, cv = cot   # hit/idx cotangents are discrete

        # Closed-form pullback (no nested jax.vjp: a nested trace inside a
        # custom_vjp bwd leaks tracer constants into lax.cond branch jaxprs
        # and fails MLIR lowering on this JAX version).
        # Winner-row fetch through the shadepack gather: one fetch of the
        # [T, 9] (v0, e1, e2) table instead of three narrow row gathers.
        from .shadepack import gather_fields
        tri9 = jnp.concatenate([v0g, e1g, e2g], axis=1)   # [T, 9]
        v0, e1, e2 = gather_fields(tri9, idx,
                                   (slice(0, 3), slice(3, 6), slice(6, 9)))
        h = jnp.cross(rd, e2)
        a = jnp.sum(e1 * h, axis=-1)
        ok = jnp.abs(a) >= EPS
        f = jnp.where(ok, 1.0 / jnp.where(ok, a, 1.0), 0.0)
        s = ro - v0
        q = jnp.cross(s, e1)
        sh = jnp.sum(s * h, axis=-1)
        rq = jnp.sum(rd * q, axis=-1)
        eq = jnp.sum(e2 * q, axis=-1)

        z = jnp.where(hit, 1.0, 0.0)
        ct = ct * z
        cu = cu * z
        cv = cv * z

        e1xe2 = jnp.cross(e1, e2)     # = -cross(e2, e1)
        e2xs = jnp.cross(e2, s)
        sxe1 = q
        e1xrd = jnp.cross(e1, rd)

        fc = f[:, None]
        # d ro
        d_ro = (ct[:, None] * fc * e1xe2
                + cu[:, None] * fc * h
                + cv[:, None] * fc * e1xrd)
        # d rd: the shared -f² (e2×e1) · (Σ cot·numerator) term + direct terms
        num = ct * eq + cu * sh + cv * rq
        d_rd = ((-f * f * num)[:, None] * (-e1xe2)
                + cu[:, None] * fc * e2xs
                + cv[:, None] * fc * sxe1)
        return None, d_ro, d_rd, None, None

    run.defvjp(fwd, bwd)

    def wrapped(scene, ro, rd, t_lower, alive=None):
        return run(scene, ro, rd, t_lower, alive)

    return wrapped
