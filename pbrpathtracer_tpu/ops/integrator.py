"""Wavefront integrator: the reference's per-pixel recursive Trace loop
(RenderFrame, pathtracer.cpp:741-817) re-architected as a bounce-major
`lax.scan` over a dense (pixel × sample) wavefront.

Per segment every lane does: closest-hit query → masked shading (ops/shade) →
next ray. A `lax.cond` skips whole segments once every lane is dead. The scan
(not while_loop) keeps the integrator reverse-mode differentiable end to end.

Progressive accumulation matches RenderFrame's buffer semantics: float accum
+= per-pass radiance, display = floor(clamp(accum/samples, 0, 1)·255), no
gamma (pathtracer.cpp:796-812).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..scene.scene import Camera, Scene
from . import rng
from .camera import generate_rays
from .hit import closest_hit, _select_intersector
from .shade import WavefrontState, shade_segment


@functools.lru_cache(maxsize=32)
def block_pixel_order(width: int, height: int, bw: int = 64, bh: int = 8):
    """Block-major pixel permutation: consecutive lanes cover bw x bh
    image rectangles instead of scanlines, so a block of consecutive lanes
    spans a compact frustum (cfg.pixel_order). Host-side constant (static
    shapes); ragged edge blocks simply produce shorter runs."""
    import numpy as np
    idx = np.arange(width * height, dtype=np.int32).reshape(height, width)
    blocks = [idx[y0:y0 + bh, x0:x0 + bw].ravel()
              for y0 in range(0, height, bh)
              for x0 in range(0, width, bw)]
    return np.concatenate(blocks)


def render_sample(scene: Scene, camera: Camera, cfg, sample_idx,
                  pixel_idx=None, seed=None):
    """Trace one sample per pixel. Returns radiance f32[N, 3].

    ``sample_idx`` is the *absolute* sample counter (progressive passes and
    checkpoint-resume pass increasing values, keeping the RNG seed-exact —
    SURVEY.md §5 checkpoint row). ``seed`` optionally overrides cfg.seed
    with a *traced* value (no recompile per seed — used by fit loops).
    """
    blocked = False
    if pixel_idx is None:
        if cfg.pixel_order == "block":
            # Compact-tile lane layout (see block_pixel_order). Bit-exact
            # per pixel: RNG and rays are keyed by the pixel VALUE; only
            # lane positions change, undone by the scatter at the end.
            pixel_idx = jnp.asarray(
                block_pixel_order(cfg.width, cfg.height))
            blocked = True
        else:
            pixel_idx = jnp.arange(cfg.width * cfg.height, dtype=jnp.int32)
    seed = jnp.uint32(cfg.seed) if seed is None else jnp.asarray(seed, jnp.uint32)
    sample_idx = jnp.uint32(sample_idx)

    ro, rd = generate_rays(camera, cfg.width, cfg.height, seed, sample_idx,
                           pixel_idx)
    state = WavefrontState.initial(ro, rd, pixel_idx)

    # NOTE: no manual hoisting of loop-invariant precomputes (triangle
    # features) — custom_vjp functions cannot close over traced values, and
    # XLA's loop-invariant code motion pulls them out of the scan anyway.
    intersect_fn = _select_intersector(scene, cfg)
    if cfg.hit_vjp == "winner":
        from .intersect_vjp import with_custom_vjp
        intersect_fn = with_custom_vjp(intersect_fn)
    elif cfg.hit_vjp == "recompute":
        # Queries are non-differentiable: their discrete argmin detaches and
        # shade re-derives the winner's (t, u, v) in closed form
        # (ops/shade._winner_straight_through). With outputs stop-gradient'd
        # AND saved as "hit_query" residuals, the backward recompute of the
        # remat'd segment has no consumer for the query — DCE removes the
        # Pallas call / BVH walk from the backward entirely (the
        # custom_vjp path re-runs it per segment).
        base_fn = intersect_fn

        def intersect_fn(s, ro, rd, tl, alive=None):
            sg = jax.lax.stop_gradient
            return jax.tree_util.tree_map(
                sg, base_fn(s, sg(ro), sg(rd), tl, alive=alive))
    elif cfg.hit_vjp != "autodiff":
        raise ValueError(f"unknown hit_vjp mode {cfg.hit_vjp!r}")
    # (An earlier JAX version failed MLIR lowering for grad-of-cond around
    # the BVH while_loop; tests/test_bvh.py::test_bvh_grad_with_skip_dead
    # pins that the workaround is no longer needed on this version.)
    skip_dead = cfg.skip_dead_segments

    from jax.ad_checkpoint import checkpoint_name

    compact = cfg.compact_wavefront
    if compact != "off":
        from .compaction import coherence_key, compact_gather, compact_sort
        compact_base = compact_sort if compact == "sort" else compact_gather
        # scenes past bvh_threshold use the (dead, octant, Morton)
        # coherence key; small scenes keep the plain dead-flag prefix sort
        if scene.num_triangles > cfg.bvh_threshold:
            def compact_fn(st, sl):
                return compact_base(st, sl, key=coherence_key(st, scene))
        else:
            compact_fn = compact_base

    def segment(carry, seg):
        state, slot = carry
        stream = rng.bounce_stream(seg)

        def live(state, slot):
            if compact != "off":
                state, slot, _ = compact_fn(state, slot)
            hit, idx, t, u, v = checkpoint_name(
                closest_hit(scene, cfg, state.ro, state.rd, seed,
                            state.pixel, sample_idx, stream,
                            intersect_fn=intersect_fn, alive=state.alive),
                "hit_query")

            def shadow_trace(p, l, sh_alive=None):
                return checkpoint_name(
                    closest_hit(scene, cfg, p, l, seed, state.pixel,
                                sample_idx, stream,
                                slot_base=rng.SLOT_NEE_OPACITY_BASE,
                                intersect_fn=intersect_fn, alive=sh_alive),
                    "hit_query")

            return shade_segment(scene, cfg, state, hit, idx, t, u, v,
                                 seg, sample_idx, seed, shadow_trace), slot

        if skip_dead:
            state, slot = jax.lax.cond(jnp.any(state.alive), live,
                                       lambda s, sl: (s, sl), state, slot)
        else:
            state, slot = live(state, slot)
        return (state, slot), None

    # Remat x unroll policy (cfg.resolved_remat / unroll_segments): a
    # rolled scan stashes residuals through dynamic_update_slice per
    # segment and wants "hits" remat (keep only the closest-hit outputs,
    # recompute shading in the backward). A fully unrolled loop lets XLA
    # place residuals in fused form, where no remat can pay; gradients are
    # identical either way.
    unroll = cfg.unroll_segments
    remat = cfg.resolved_remat(unroll, scene)
    if remat == "hits":
        segment = jax.checkpoint(
            segment,
            policy=jax.checkpoint_policies.save_only_these_names(
                "hit_query"))
    elif remat == "all":
        segment = jax.checkpoint(segment)

    segs = jnp.arange(cfg.resolved_max_segments(), dtype=jnp.uint32)
    slot = jnp.arange(state.ro.shape[0], dtype=jnp.int32)
    (state, slot), _ = jax.lax.scan(segment, (state, slot), segs,
                                    unroll=unroll)
    radiance = state.radiance
    if compact != "off":
        # undo the lane reordering: radiance back to input pixel order
        from .compaction import scatter_to_slots
        radiance = scatter_to_slots(radiance, slot)
    if blocked:
        # undo the block layout: radiance back to scanline pixel order
        radiance = jnp.zeros_like(radiance).at[pixel_idx].set(radiance)
    return radiance


def render_accumulate(scene: Scene, camera: Camera, cfg, accum,
                      sample_start, num_samples: int, seed=None):
    """Add ``num_samples`` progressive passes onto ``accum`` (f32[N,3]).

    Returns the new accumulation buffer; caller tracks the sample counter
    (mirrors mTotalImg/mSamples, pathtracer.cpp:745-753, 798-800).
    """
    sample_start = jnp.asarray(sample_start, jnp.uint32)

    def body(acc, k):
        return acc + render_sample(scene, camera, cfg, sample_start + k,
                                   seed=seed), None
    ks = jnp.arange(num_samples, dtype=jnp.uint32)
    accum, _ = jax.lax.scan(body, accum, ks)
    return accum


def render(scene: Scene, camera: Camera, cfg, seed=None):
    """Render cfg.spp samples; returns mean radiance f32[H, W, 3]."""
    accum = jnp.zeros((cfg.width * cfg.height, 3), jnp.float32)
    accum = render_accumulate(scene, camera, cfg, accum, 0, cfg.spp,
                              seed=seed)
    img = accum / jnp.float32(cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)


def tonemap_u8(accum, samples):
    """Display conversion, parity with pathtracer.cpp:802-812: clamp the
    running mean to [0,1] and truncate to bytes (no gamma)."""
    res = jnp.clip(accum / jnp.float32(samples), 0.0, 1.0)
    return (res * 255.0).astype(jnp.uint8)
