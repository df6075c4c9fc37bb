"""Wavefront shading: one segment of the reference's recursive Trace()
(pathtracer.cpp:545-732) as branchless masked vector math.

Each call consumes one bounce segment for every lane simultaneously:
hit-point setup (normals, normal map, face-forward), the iter-budget gate,
texture overrides, Russian roulette, lobe selection for OPAQUE and
TRANSLUCENT materials, next-event estimation, and next-ray generation.
Discrete decisions use keyed RNG slots (ops/rng.py) so the CPU oracle replays
the identical decision tree.

Reference semantic quirks reproduced on purpose (SURVEY.md §3.3, §7):
  * specular-reflection and refraction bounces refund the ``iter`` depth
    budget (pathtracer.cpp:625,701,711) — only Russian roulette (driven by
    ``depth``) bounds specular chains;
  * Russian roulette uses the *untextured* material diffuse for its survive
    probability and applies no 1/p compensation (pathtracer.cpp:588-594) —
    the unbiased variant sits behind RenderConfig.rr_reweight;
  * NEE has no 1/r² falloff, no area pdf and no ×num_lights factor
    (pathtracer.cpp:528-530) — physical variant behind nee_physical;
  * the glossy cone basis is built from the reflection vector but the
    degeneracy test reads n.x (pathtracer.cpp:618), and the translucent
    rough refraction "normal" mixes a basis around r with a final axis along
    n (pathtracer.cpp:648-653);
  * Schlick's approximation uses (1-c)² — not the physical (1-c)⁵
    (pathtracer.cpp:668).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..scene.scene import Scene
from ..utils.constants import (
    EPS, FLT_EPSILON, OPAQUE,
    TEX_DIFFUSE, TEX_NORMAL, TEX_EMISSIVE, TEX_ROUGHNESS, TEX_METALLIC,
    NO_TEXTURE,
)
from ..utils.pytree import pytree_dataclass
from . import rng, shadepack as sp
from .linalg import dot, reflect, safe_normalize, safe_sqrt
from .texture import sample_texture

TWO_PI = np.float32(2.0 * np.pi)


@pytree_dataclass
class WavefrontState:
    """Per-lane path state carried across bounce segments."""

    ro: jnp.ndarray          # f32[N,3] ray origin
    rd: jnp.ndarray          # f32[N,3] ray direction (normalized)
    throughput: jnp.ndarray  # f32[N,3] product of BRDF factors so far
    radiance: jnp.ndarray    # f32[N,3] accumulated estimate
    alive: jnp.ndarray       # bool[N]
    inside: jnp.ndarray      # bool[N] inside a dielectric (Trace's `inside`)
    itr: jnp.ndarray         # i32[N] `iter` depth budget (specular refunds)
    depth: jnp.ndarray       # i32[N] true recursion depth (drives RR)
    pixel: jnp.ndarray       # i32[N] absolute pixel index (RNG key)

    @classmethod
    def initial(cls, ro, rd, pixel):
        N = ro.shape[0]
        f32 = jnp.float32
        return cls(
            ro=ro, rd=rd,
            throughput=jnp.ones((N, 3), f32),
            radiance=jnp.zeros((N, 3), f32),
            alive=jnp.ones((N,), bool),
            inside=jnp.zeros((N,), bool),
            itr=jnp.zeros((N,), jnp.int32),
            depth=jnp.zeros((N,), jnp.int32),
            pixel=pixel,
        )


def cone_direction(basis, last_axis, nx, thresh, w, theta):
    """The reference's hemisphere/cone sampler (pathtracer.cpp:606-623 etc).

    u = normalize(cross(e0, basis)), v = normalize(cross(u, basis)),
    dir = w cos(2πθ) u + w sin(2πθ) v + sqrt(1-w²) last_axis, normalized.
    ``e0`` is (1,0,0) unless |nx| ≥ thresh, then (1,1,1) — the degeneracy test
    always reads n.x even when the basis is built around r (quirk preserved).
    """
    cond = (jnp.abs(nx) < thresh)[:, None]
    e0 = jnp.where(cond,
                   jnp.array([1.0, 0.0, 0.0], jnp.float32),
                   jnp.array([1.0, 1.0, 1.0], jnp.float32))
    u = safe_normalize(jnp.cross(e0, basis))
    v = safe_normalize(jnp.cross(u, basis))
    ang = TWO_PI * theta
    d = (w * jnp.cos(ang))[:, None] * u + (w * jnp.sin(ang))[:, None] * v \
        + safe_sqrt(1.0 - w * w)[:, None] * last_axis
    return safe_normalize(d)


def direct_illumination(scene: Scene, p, n, diffuse, seed, pixel, sample_idx,
                        stream, shadow_trace, nee_physical: bool,
                        draws=None, alive=None):
    """NEE (DirectIllumimation, pathtracer.cpp:504-531).

    Uniform light pick, (√u, v) area warp, shadow ray that must FIRST-hit the
    chosen light triangle; contribution = L_emit·I · diffuse · dot(n, l). The
    physical variant adds the area-measure pdf conversion the reference
    omits: × num_lights × area × cos_light / r².

    ``draws`` optionally supplies the (light-pick, u, v) uniforms (slots
    13-15) when the caller already drew the group.
    """
    L = scene.num_lights
    if L == 0:
        return jnp.zeros_like(p)

    if draws is None:
        _, u_pick, u_su, sv = rng.rand_slots4(seed, pixel, sample_idx, stream,
                                              rng.SLOT_NEE_LIGHT // 4)
    else:
        u_pick, u_su, sv = draws
    lid = jnp.clip(jnp.floor(u_pick * L).astype(jnp.int32), 0, L - 1)
    # ONE fetch for all light data (shadepack.gather_fields)
    lv0, le1, le2, lcolor, ltri_f = sp.gather_fields(
        sp.build_light_pack(scene), lid, sp.LIGHT_FIELDS)
    ltri = ltri_f.astype(jnp.int32)

    lv1 = lv0 + le1
    lv2 = lv0 + le2
    su = jnp.sqrt(u_su)
    w0 = 1.0 - su
    w1 = su * (1.0 - sv)
    w2 = su * sv
    vlight = w0[:, None] * lv0 + w1[:, None] * lv1 + w2[:, None] * lv2

    to_l = vlight - p
    l = safe_normalize(to_l)
    cos_n = dot(n, l)
    facing = cos_n > 0.0  # ref: dot(-n,-l) <= 0 → reject (pathtracer.cpp:517)

    # only lanes whose NEE contribution survives the outer mask AND face
    # the sampled light need the shadow query (pathtracer.cpp:517 rejects
    # back-facing before casting) — the rest skip it in the Pallas kernel
    # and the BVH walk
    sh_alive = None if alive is None else (alive & facing)
    sh_hit, sh_idx, _, _, _ = shadow_trace(p, l, sh_alive)
    visible = ~(sh_hit & (sh_idx != ltri))  # no-hit counts as visible (:522-526)

    contrib = lcolor * diffuse * cos_n[:, None]

    if nee_physical:
        area = 0.5 * jnp.linalg.norm(jnp.cross(le1, le2), axis=-1)
        r2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), 1e-12)
        ln = safe_normalize(jnp.cross(le1, le2))
        cos_l = jnp.abs(dot(ln, l))
        contrib = contrib * (L * area * cos_l / r2)[:, None] / np.float32(np.pi)

    return jnp.where((facing & visible)[:, None], contrib, 0.0)


import jax


@jax.custom_vjp
def _graft(orig, rec, ok):
    """Straight-through: forward returns ``orig`` EXACTLY (the recompute
    chain feeding ``rec`` is dead code in a forward-only graph — XLA DCEs
    it, so un-differentiated renders pay nothing for hit_vjp="recompute");
    backward routes the cotangent to BOTH orig and (where ok) rec."""
    return orig


def _graft_fwd(orig, rec, ok):
    return orig, ok


def _graft_bwd(ok, cot):
    return cot, jnp.where(ok, cot, jnp.zeros_like(cot)), None


_graft.defvjp(_graft_fwd, _graft_bwd)


def _winner_straight_through(ro, rd, v0, e1, e2, hit, t, bu, bv):
    """Re-derive (t, u, v) for the winning triangle differentiably and graft
    the derivatives onto the intersector's (stop-gradient'd) values.

    Möller–Trumbore with the safe-reciprocal guard of ops/intersect.py;
    misses and degenerate denominators keep zero derivative (their values
    are frozen query outputs either way). The graft is a custom-VJP
    identity on the query values, so the whole recompute vanishes from
    forward-only graphs (``orig + (rec - stop_grad(rec))`` would not: XLA
    cannot DCE it)."""
    h = jnp.cross(rd, e2)
    a = jnp.sum(e1 * h, axis=-1)
    ok = hit & (jnp.abs(a) >= EPS)
    f = jnp.where(ok, 1.0 / jnp.where(ok, a, 1.0), 0.0)
    s = ro - v0
    q = jnp.cross(s, e1)
    t_rec = f * jnp.sum(e2 * q, axis=-1)
    u_rec = f * jnp.sum(s * h, axis=-1)
    v_rec = f * jnp.sum(rd * q, axis=-1)
    return (_graft(t, t_rec, ok), _graft(bu, u_rec, ok),
            _graft(bv, v_rec, ok))


def shade_segment(scene: Scene, cfg, state: WavefrontState,
                  hit, tri_idx, t, bu, bv,
                  seg, sample_idx, seed, shadow_trace) -> WavefrontState:
    """Advance every lane by one bounce segment. Returns the new state."""
    tex = scene.textures
    N = state.ro.shape[0]
    stream = rng.bounce_stream(seg)

    # Grouped draws: slots 4-15 are exactly pcg4d groups 1-3 (ops/rng.py) —
    # three hashes for the twelve per-segment decisions.
    d_rr, d_lobe_sel, w_l, th_l = rng.rand_slots4(
        seed, state.pixel, sample_idx, stream, rng.SLOT_RR // 4)
    w_rc, th_rc, d_fresnel, d_refl = rng.rand_slots4(
        seed, state.pixel, sample_idx, stream, rng.SLOT_REFRACT_CONE_W // 4)
    d_transl, d_pick, d_nee_u, d_nee_v = rng.rand_slots4(
        seed, state.pixel, sample_idx, stream, rng.SLOT_TRANSLUCENCY // 4)

    active = state.alive & hit
    rd = state.rd

    # ONE fetch serves every triangle+material attribute
    # (shadepack.gather_fields); fields come out as slices of the block.
    (f_normal, f_n0, f_n1, f_n2, f_uv0, f_uv1, f_uv2, f_smooth,
     f_diffuse, f_specular, f_emissive, f_emiss_int, f_roughness,
     f_reflectiveness, f_transl, f_ior, f_mtype, f_texidx,
     f_tangent, f_bitangent, f_v0, f_e1, f_e2) = sp.gather_fields(
         sp.build_tri_pack(scene), tri_idx, sp.TRI_FIELDS)

    if cfg.hit_vjp == "recompute":
        # The intersectors are stop-gradient'd (ops/integrator.py); with the
        # winner index fixed, (t, u, v) are closed-form Möller–Trumbore
        # ratios of (ro, rd) against that one triangle (pathtracer.cpp:
        # 373-409). Straight-through: the recomputed value minus its own
        # stop_gradient is identically zero in the forward (query values
        # stay bit-exact) but carries the winner-local pullback to ro, rd
        # and the winner's geometry — the O(N) equivalent of
        # ops/intersect_vjp.py, inlined where XLA can fuse it.
        t, bu, bv = _winner_straight_through(
            state.ro, rd, f_v0, f_e1, f_e2, hit, t, bu, bv)

    p = state.ro + rd * t[:, None]
    w0 = (1.0 - bu - bv)[:, None]
    uv = (w0 * f_uv0 + bu[:, None] * f_uv1
          + bv[:, None] * f_uv2)  # GetUV (pathtracer.cpp:533-536)

    # ---- shading normal (pathtracer.cpp:555-569) ----
    n = f_normal
    smooth_n = safe_normalize(w0 * f_n0 + bu[:, None] * f_n1
                              + bv[:, None] * f_n2)
    n = jnp.where((f_smooth != 0.0)[:, None], smooth_n, n)

    if scene.has_any_texture:
        tex_idx = f_texidx.astype(jnp.int32)
        nt_idx = tex_idx[:, TEX_NORMAL]
        has_ntex = active & (nt_idx != NO_TEXTURE)
        texel = sample_texture(tex, nt_idx, uv,
                               jnp.zeros((N, 4), jnp.float32), has_ntex)
        nt = texel[:, :3] * 2.0 - 1.0
        nt = jnp.where((nt[:, 2] <= 0.0)[:, None],
                       jnp.stack([nt[:, 0], nt[:, 1],
                                  jnp.full((N,), EPS)], axis=-1),
                       nt)
        nt = safe_normalize(nt)
        tbn_n = safe_normalize(
            nt[:, 0:1] * f_tangent
            + nt[:, 1:2] * f_bitangent
            + nt[:, 2:3] * n)
        n = jnp.where(has_ntex[:, None], tbn_n, n)

    n = jnp.where((dot(n, rd) > 0.0)[:, None], -n, n)  # face-forward (:567)
    p = p + n * EPS                                     # offset (:569)

    # ---- iter-budget gate (pathtracer.cpp:571: `if (iter < mMaxDepth)`) ----
    active = active & (state.itr < cfg.max_depth)

    # ---- texture overrides (pathtracer.cpp:573-584) ----
    base_diffuse = f_diffuse
    diffuse = base_diffuse
    emiss = f_emissive
    roughness = f_roughness
    reflectiveness = f_reflectiveness
    if scene.has_any_texture:
        def tex_override(slot):
            ti = tex_idx[:, slot]
            has = active & (ti != NO_TEXTURE)
            tx = sample_texture(tex, ti, uv, jnp.zeros((N, 4), jnp.float32), has)
            return has, tx
        has_d, tx_d = tex_override(TEX_DIFFUSE)
        diffuse = jnp.where(has_d[:, None], tx_d[:, :3], diffuse)
        has_e, tx_e = tex_override(TEX_EMISSIVE)
        emiss = jnp.where(has_e[:, None], tx_e[:, :3], emiss)
        has_r, tx_r = tex_override(TEX_ROUGHNESS)
        roughness = jnp.where(has_r, tx_r[:, 0], roughness)
        has_m, tx_m = tex_override(TEX_METALLIC)
        reflectiveness = jnp.where(has_m, tx_m[:, 0], reflectiveness)

    depth = state.depth + 1   # (:586-587; only consumed by active lanes)
    itr = state.itr + 1

    # ---- Russian roulette (pathtracer.cpp:588-594) ----
    prob = jnp.minimum(0.95, jnp.max(base_diffuse, axis=-1))  # untextured!
    rr_active = depth >= cfg.max_depth
    rr_kill = rr_active & (d_rr > prob)
    active = active & ~rr_kill
    if cfg.rr_reweight:
        rr_w = jnp.where(rr_active & ~rr_kill,
                         1.0 / jnp.maximum(prob, 1e-6), 1.0)
        throughput = state.throughput * rr_w[:, None]
    else:
        throughput = state.throughput

    # ---- lobe directions ----
    r = reflect(rd, n)
    nx = n[:, 0]
    uniform_dir = cone_direction(n, n, nx, 1.0 - EPS, w_l, th_l)
    glossy_dir = cone_direction(r, r, nx, 1.0 - FLT_EPSILON,
                                w_l * roughness, th_l)
    spec_dir = jnp.where((roughness == 1.0)[:, None], uniform_dir,
                         jnp.where((roughness == 0.0)[:, None], r, glossy_dir))

    is_opaque = f_mtype == OPAQUE
    op_spec = is_opaque & (d_lobe_sel < reflectiveness)

    # Optional GGX microfacet lobe for opaque specular (ops/ggx.py): smooth
    # in roughness (inverse rendering) where the reference cone is hit-flip
    # noise. Translucent reflection keeps the reference lobes.
    spec_weight = None
    if cfg.brdf == "ggx":
        from .ggx import ggx_sample
        ggx_dir, ggx_w = ggx_sample(rd, n, roughness, w_l, th_l)
        spec_dir = jnp.where(op_spec[:, None], ggx_dir, spec_dir)
        spec_weight = jnp.where(op_spec, ggx_w, 1.0)

    # ---- translucent decisions (pathtracer.cpp:643-675) ----
    refract_n_cone = cone_direction(r, n, nx, 1.0 - FLT_EPSILON,
                                    w_rc * roughness, th_rc)
    refract_n = jnp.where((roughness != 0.0)[:, None], refract_n_cone, n)
    ior = f_ior
    eta = jnp.where(state.inside, ior, 1.0 / ior)
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    cth = jnp.abs(dot(rd, refract_n))
    k = 1.0 - eta * eta * (1.0 - cth * cth)
    re = r0 + (1.0 - r0) * (1.0 - cth) * (1.0 - cth)  # (1-c)² quirk (:668)
    tr_reflect = ~is_opaque & ((k < 0.0)
                               | (d_fresnel < re)
                               | (d_refl < reflectiveness))
    tr_refract = (~is_opaque & ~tr_reflect
                  & (d_transl < f_transl))
    tr_diff = ~is_opaque & ~tr_reflect & ~tr_refract

    refr_dir = safe_normalize(
        eta[:, None] * rd
        - (eta * dot(n, rd) + safe_sqrt(k))[:, None] * refract_n)

    # ---- NEE for diffuse branches (pathtracer.cpp:638, 724) ----
    diffuse_branch = (is_opaque & ~op_spec) | tr_diff
    nee = direct_illumination(scene, p, n, diffuse, seed, state.pixel,
                              sample_idx, stream, shadow_trace,
                              cfg.nee_physical,
                              draws=(d_pick, d_nee_u, d_nee_v),
                              alive=active & diffuse_branch)
    nee = jnp.where((active & diffuse_branch)[:, None], nee, 0.0)

    # ---- resolve branches ----
    spec_branch = op_spec | tr_reflect
    new_dir = jnp.where(spec_branch[:, None], spec_dir,
                        jnp.where(tr_refract[:, None], refr_dir, uniform_dir))
    throughput_factor = jnp.where(spec_branch[:, None], f_specular, diffuse)
    if spec_weight is not None:
        throughput_factor = throughput_factor * spec_weight[:, None]

    emitted = emiss * f_emiss_int[:, None]
    contribution = emitted + nee
    radiance = state.radiance + jnp.where(active[:, None],
                                          throughput * contribution, 0.0)
    throughput = jnp.where(active[:, None], throughput * throughput_factor,
                           throughput)

    # iter refund for specular/refraction (:625, :701, :711)
    itr = itr - (spec_branch | tr_refract).astype(jnp.int32)
    inside = jnp.where(active & tr_refract, ~state.inside, state.inside)
    new_ro = jnp.where(tr_refract[:, None], p - n * (EPS * 2.0), p)  # (:709)

    return WavefrontState(
        ro=jnp.where(active[:, None], new_ro, state.ro),
        rd=jnp.where(active[:, None], new_dir, state.rd),
        throughput=throughput,
        radiance=radiance,
        alive=active,
        inside=inside,
        itr=jnp.where(active, itr, state.itr),
        depth=jnp.where(active, depth, state.depth),
        pixel=state.pixel,
    )
