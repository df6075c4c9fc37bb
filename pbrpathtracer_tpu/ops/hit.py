"""Closest-hit queries with stochastic-opacity semantics.

The reference's Hit() draws ``Rand() < opacity`` per candidate leaf
intersection during BVH traversal and rejects transparent hits
(pathtracer.cpp:463-488). The wavefront equivalent: find the closest hit,
consult the opacity texture, and on rejection *re-trace past it* using an
exclusive lower bound on t — a statically bounded number of attempts
(RenderConfig.opacity_attempts). Draws are keyed (pixel, sample, stream,
SLOT_OPACITY_BASE + attempt) so the CPU oracle replays them exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene.scene import Scene
from ..utils.constants import TEX_OPACITY, NO_TEXTURE
from . import rng
from .intersect import intersect_classic, intersect_matmul
from .texture import sample_texture


def _resolve_intersector_name(scene: Scene, cfg, backend=None) -> str:
    """ "auto" → the BVH walk when the scene has one and is past
    bvh_threshold, else the fused Pallas kernel on the GPU and the dense
    matmul formulation on other backends (the kernel compiles only for
    the GPU). ``backend`` defaults to jax.default_backend()."""
    name = cfg.intersector
    if name != "auto":
        return name
    if scene.accel is not None and scene.num_triangles > cfg.bvh_threshold:
        return "bvh"
    if (backend or jax.default_backend()) == "gpu":
        return "pallas"
    return "matmul"


def _select_intersector(scene: Scene, cfg):
    """Resolve cfg.intersector to fn(scene, ro, rd, t_lower, alive=None)
    -> hit tuple (``alive``: dead lanes report a clean miss and — on the
    Pallas/BVH routes — skip their intersection work)."""
    name = _resolve_intersector_name(scene, cfg)
    if name == "matmul":
        return lambda s, ro, rd, tl, alive=None: intersect_matmul(
            s.geom, ro, rd, tl, alive=alive)
    if name == "classic":
        return lambda s, ro, rd, tl, alive=None: intersect_classic(
            s.geom, ro, rd, tl, alive=alive)
    if name == "pallas":
        from ..kernels.intersect_pallas import intersect_pallas
        return lambda s, ro, rd, tl, alive=None: intersect_pallas(
            s, ro, rd, tl, alive=alive)
    if name == "bvh":
        from ..accel.traverse import intersect_bvh
        if scene.accel is None:
            raise ValueError("intersector='bvh' but scene has no accel; "
                             "build the scene with with_accel()")
        return intersect_bvh
    raise ValueError(f"unknown intersector {name!r}")


def interpolate_uv(scene: Scene, tri_idx, u, v):
    """Barycentric UV (GetUV, pathtracer.cpp:533-536):
    (1-u-v)*uv1 + u*uv2 + v*uv3."""
    g = scene.geom
    w0 = (1.0 - u - v)[:, None]
    return (w0 * g.uv0[tri_idx] + u[:, None] * g.uv1[tri_idx]
            + v[:, None] * g.uv2[tri_idx])


def closest_hit(scene: Scene, cfg, ro, rd, seed, pixel, sample_idx, stream,
                slot_base=rng.SLOT_OPACITY_BASE, intersect_fn=None,
                alive=None):
    """Closest hit with stochastic alpha.

    Returns (hit bool[N], tri_idx i32[N], t f32[N], u f32[N], v f32[N]).
    ``stream`` is the bounce-segment RNG stream; shadow rays pass
    ``slot_base=SLOT_NEE_OPACITY_BASE``. ``intersect_fn(scene, ro, rd,
    t_lower, alive=None)`` defaults to the cfg-selected intersector.
    ``alive`` masks dead lanes to a clean miss and lets the Pallas kernel
    and the BVH walk skip their work (live-lane results are bit-identical either way).
    """
    if intersect_fn is None:
        intersect_fn = _select_intersector(scene, cfg)
    assert cfg.opacity_attempts <= rng.MAX_OPACITY_ATTEMPTS, \
        "opacity slots are one 4-draw RNG group"
    # draws[attempt] below reads slot 4*(slot_base//4)+attempt — only equal
    # to the oracle's rand_slot(slot_base+attempt) when the base is aligned.
    assert slot_base % 4 == 0, "opacity slot base must be group-aligned"

    N = ro.shape[0]
    t_lower = jnp.zeros((N,), jnp.float32)

    hit, idx, t, u, v = intersect_fn(scene, ro, rd, t_lower, alive=alive)
    if not scene.has_opacity_tex:
        return hit, idx, t, u, v

    # Opacity re-trace loop (statically unrolled). A lane is *settled* once
    # its candidate is a miss, an opaque-textured accept, or has no opacity
    # texture; settled lanes never re-draw (a fresh draw on the same hit
    # would flip acceptances the oracle already made).
    from .shadepack import build_uv_opacity_pack, gather_fields
    uvpack = build_uv_opacity_pack(scene)   # one row fetch per attempt
    uvfields = (slice(0, 2), slice(2, 4), slice(4, 6), 6)
    # slots (slot_base..slot_base+3) are one pcg4d group (ops/rng.py layout)
    draws = rng.rand_slots4(seed, pixel, sample_idx, stream, slot_base // 4)
    result = (hit, idx, t, u, v)
    settled = jnp.zeros((N,), bool)
    for attempt in range(cfg.opacity_attempts):
        hit, idx, t, u, v = result
        p_uv0, p_uv1, p_uv2, p_otex = gather_fields(uvpack, idx, uvfields)
        mid = p_otex.astype(jnp.int32)
        has_otex = hit & (mid != NO_TEXTURE)
        w0 = (1.0 - u - v)[:, None]
        uv = w0 * p_uv0 + u[:, None] * p_uv1 + v[:, None] * p_uv2
        texel = sample_texture(scene.textures, mid, uv,
                               jnp.ones((N, 4), jnp.float32), has_otex)
        opacity = texel[:, 0]
        draw = draws[attempt]
        # Reference accepts when Rand() < opacity (pathtracer.cpp:475).
        rejected = ~settled & has_otex & ~(draw < opacity)
        settled = settled | ~rejected
        if attempt == cfg.opacity_attempts - 1:
            # Budget exhausted: accept the candidate (bounded deviation; the
            # oracle applies the same rule).
            break
        t_lower = jnp.where(rejected, t, t_lower)
        # settled lanes keep their result: only unsettled lanes need the
        # re-trace, so they alone stay "alive" for the query
        re_alive = ~settled if alive is None else (alive & ~settled)
        nh, ni, nt, nu, nv = intersect_fn(scene, ro, rd, t_lower,
                                          alive=re_alive)
        result = (jnp.where(settled, hit, nh), jnp.where(settled, idx, ni),
                  jnp.where(settled, t, nt), jnp.where(settled, u, nu),
                  jnp.where(settled, v, nv))
    return result
