"""Render configuration — replaces the reference's GUI-state globals
(main.cpp:78-136: trace depth, resolution, auto-res, target samples, camera
F / focal-dist, nav speed) with an explicit static dataclass. Static fields
participate in jit specialization (shapes / loop bounds / feature gates)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image (main.cpp:50-51 defaults 1024x768; depth default pathtracer.cpp:15)
    width: int = 1024
    height: int = 768
    max_depth: int = 3          # trace depth, GUI range 1-10 (main.cpp:1463-1512)
    spp: int = 1                # samples per render_step pass (reference: 1/pass)
    seed: int = 0

    # Wavefront loop bound. The reference's specular/refraction bounces refund
    # the ``iter`` depth budget (pathtracer.cpp:625,701,711) so specular chains
    # are bounded only by Russian roulette; a fixed cap replaces the unbounded
    # recursion (SURVEY.md §7 hard-part 1). The oracle uses the same cap, so
    # parity is exact by construction.
    max_segments: int | None = None

    # Stochastic-opacity re-trace attempts per hit query (Hit,
    # pathtracer.cpp:469-476 restarts traversal on alpha rejection; unbounded
    # there, statically bounded here).
    opacity_attempts: int = 4

    # Estimator-parity flags (SURVEY.md §7 hard-part 6). False reproduces the
    # reference's biased estimators exactly; True enables the corrected ones.
    rr_reweight: bool = False     # divide by survive-prob after RR (ref omits: pathtracer.cpp:588-594)
    nee_physical: bool = False    # area-pdf/r^2/num-lights weighting (ref omits: pathtracer.cpp:528-530)
    # Opaque specular lobe model: "reference" = the cone around the mirror
    # direction (pathtracer.cpp:606-623); "ggx" = importance-sampled GGX
    # microfacet (ops/ggx.py) — smooth roughness gradients for inverse
    # rendering. Diffuse/NEE/RR/translucent semantics are unchanged.
    brdf: str = "reference"

    # Intersector selection: "auto" picks the BVH walk for scenes past
    # bvh_threshold that carry a BVH, else the fused Pallas kernel on the
    # GPU and the dense matmul formulation elsewhere (ops/hit.py).
    intersector: str = "auto"    # auto | pallas | matmul | classic | bvh
    bvh_threshold: int = 4096     # tri count above which auto uses the BVH
    # How hit queries participate in reverse-mode AD:
    #   "recompute" (default) — the intersectors are stop-gradient'd (their
    #     discrete argmin detaches anyway) and shade recomputes (t, u, v)
    #     for the *winning* triangle in closed form, straight-through so the
    #     forward values stay bit-exact. Gradients flow to (ro, rd) AND to
    #     the winner's geometry through the shading pack. The opaque query
    #     (Pallas call / BVH while_loop) is dead code in the backward, so
    #     jax.checkpoint's recompute elides it instead of re-running it per
    #     segment.
    #   "winner" — custom VJP wrapper (ops/intersect_vjp.py): O(N) closed
    #     -form pullback to (ro, rd) only; custom_vjp is opaque to remat
    #     DCE, so the query re-runs inside the backward.
    #   "autodiff" — differentiate the raw intersector (matmul/classic
    #     only; the BVH while_loop has no reverse rule). Debug/baseline.
    hit_vjp: str = "recompute"
    # Rematerialization of the bounce-segment body under reverse AD:
    #   "auto" (default) — "off" when the segment loop is fully unrolled
    #   on a small scene (XLA can fuse residuals in place), "hits" under
    #   the rolled lax.scan;
    #   "hits" — recompute shading in the backward pass but keep the
    #   closest-hit query outputs as residuals (cheap [N] rows; skips
    #   re-running the intersection kernels);
    #   "all" — plain jax.checkpoint (recompute everything);
    #   "off" — stash all residuals (XLA default).
    remat_segments: str = "auto"

    # Segment-loop unroll factor of the lax.scan (1 = rolled).
    unroll_segments: int = 1

    # Live-lane wavefront compaction (ops/compaction.py): reorder lanes
    # each segment so live lanes form a prefix. "off" | "sort" (one
    # variadic stable sort of the state) | "gather" (perm sort +
    # per-column gathers). Semantically exact either way (keyed RNG
    # travels with the lane; ops/compaction.py on the ULP caveat under
    # whole-render jit).
    compact_wavefront: str = "off"

    # Wavefront pixel ordering: "scan" | "block". "block" lays lanes out
    # in 64x8-pixel blocks instead of scanline order, so a block of
    # consecutive lanes covers a compact image rectangle. Pure lane
    # permutation: per-pixel results are bit-exact (RNG is keyed by pixel
    # id, not lane position); costs one [N,3] scatter at the end of the
    # sample.
    pixel_order: str = "scan"

    # Structurally skip bounce segments once every lane is dead (lax.cond).
    # Big win for renders with dead tails (all routes, incl. BVH;
    # regression-pinned in tests/test_bvh.py).
    skip_dead_segments: bool = True

    def resolved_max_segments(self) -> int:
        if self.max_segments is not None:
            return self.max_segments
        return 2 * self.max_depth + 2

    def __post_init__(self):
        if self.pixel_order not in ("scan", "block"):
            raise ValueError(f"unknown pixel_order {self.pixel_order!r}")
        if self.compact_wavefront not in ("off", "sort", "gather"):
            raise ValueError(
                f"unknown compact_wavefront {self.compact_wavefront!r}")

    def resolved_remat(self, unroll: int, scene=None) -> str:
        """Remat policy given the resolved unroll factor (and the scene).

        "off" (stash all residuals) is only safe for SMALL scenes: the
        stash grows with every unfused intermediate, and at 512² rays x
        50k textured triangles it reaches tens of GB, where "hits" remat
        keeps residuals to the per-query output rows. Auto therefore picks
        "off" only when the segment loop is unrolled AND the scene is small
        (≤ bvh_threshold triangles), else "hits"."""
        if self.remat_segments != "auto":
            return self.remat_segments
        small_scene = (scene is not None
                       and scene.num_triangles <= self.bvh_threshold)
        if unroll >= self.resolved_max_segments() and small_scene:
            return "off"
        return "hits"

    def with_auto_segments(self, scene, tol: float = 1e-3) -> "RenderConfig":
        """Replace max_segments with suggest_max_segments(scene, ...)."""
        return self.replace(max_segments=suggest_max_segments(
            scene, self.max_depth, tol=tol))

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def suggest_max_segments(scene, max_depth: int, tol: float = 1e-3,
                         hard_cap: int = 128) -> int:
    """Auto-size the wavefront segment cap from RR survival statistics.

    The reference's specular/refraction bounces refund the iter budget, so
    mirror chains are bounded only by Russian roulette: once depth ≥
    max_depth every further bounce survives with p = min(0.95,
    max(diffuse)) and multiplies throughput by the specular (≤ s_max)
    color (pathtracer.cpp:588-594, 625). The expected radiance left in a
    path truncated after k RR-gated segments is therefore ≤ (p·s_max)^k
    relative to its throughput at RR onset. This picks the smallest cap
    whose bound is below ``tol`` (never below the 2·depth+2 default).
    """
    import numpy as np
    d = np.asarray(scene.materials.diffuse)
    s = np.asarray(scene.materials.specular)
    refl = np.asarray(scene.materials.reflectiveness)
    transl = np.asarray(scene.materials.translucency)
    # only materials that can extend a specular/refraction chain matter
    chain = (refl > 0) | (transl > 0)
    if not chain.any():
        return 2 * max_depth + 2
    p = min(0.95, float(d[chain].max(initial=0.0)))
    s_max = min(1.0, float(s[chain].max(initial=0.0)))
    q = p * s_max
    base = 2 * max_depth + 2
    if q <= 0.0:
        return base
    if q >= 1.0:
        return hard_cap
    import math
    k = math.ceil(math.log(tol) / math.log(q))
    return min(hard_cap, max(base, max_depth + k))
