"""Headless preview renderer + pick buffer.

The reference previews the scene by OpenGL rasterization with a second
render target carrying (objectId+1, elementId+1) for mouse picking
(Display, main.cpp:2796-2977; fPrev pickcolor, shaders.h:168; readback
main.cpp:3239-3247). The headless equivalent is a ray cast over the same
camera: flat-shaded color with a headlight term, and an exact
(object_id, element_id) id-buffer — same information the GL pick pass
provides, computed in one jit.

Transparency: the reference draws opaque elements first, then alpha-blends
transparent ones (material TRANSLUCENT or an opacity texture, unless
highlighted) with depth writes off (main.cpp:2934-2955, two-pass loop).
The fragment alpha comes from the preview shader (shaders.h:151-164):

    alphaSpec  = mix(0.3, 1.0, reflectiveness)
               + specFact * mix(0.4, 1.0, reflectiveness)
    alpha      = clamp(clamp(alphaSpec, 0, 1) + (1 - translucency), 0, 1)
    alpha     *= opacityTex.r                      (when an opacity map)

Here the same information is produced by front-to-back depth peeling:
up to ``transparency_layers`` transparent hits composite over the first
opaque hit with exactly that alpha. (Deviation, documented: the GL pass
blends unsorted in element order against the opaque depth buffer; the ray
cast composites in true depth order — strictly more faithful to the scene,
identical for the common single-layer case.)

`pick(x, y)` reproduces the click→selection logic: ids come from the
front-most surface (transparent included — the GL pick attachment is
written by both passes), with -1 for background.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene.scene import Camera, Scene
from .camera import generate_rays
from .hit import _select_intersector, interpolate_uv
from .linalg import dot, safe_normalize
from .texture import sample_texture
from ..utils.constants import (NO_TEXTURE, TEX_DIFFUSE, TEX_OPACITY,
                               TRANSLUCENT)


def _shade_hit(scene, hit, idx, u, v, rd, highlight_mask):
    """Per-lane preview shade + alpha for one peeled hit layer.

    Returns (shade f32[N,3], alpha f32[N], transparent bool[N]).
    ``transparent`` follows main.cpp:2924-2932: TRANSLUCENT material or an
    opacity texture, except for highlighted elements (drawn opaque).
    """
    g, m = scene.geom, scene.materials
    N = rd.shape[0]
    mid = g.mat_id[idx]
    n = g.normal[idx]
    n = jnp.where((dot(n, rd) > 0.0)[:, None], -n, n)

    base = m.diffuse[mid]
    otex_alpha = jnp.ones((N,), jnp.float32)
    has_otex = jnp.zeros((N,), bool)
    if scene.has_any_texture:
        uv = interpolate_uv(scene, idx, u, v)
        ti = m.tex_index[mid, TEX_DIFFUSE]
        has = hit & (ti != NO_TEXTURE)
        texel = sample_texture(scene.textures, ti, uv,
                               jnp.zeros((N, 4), jnp.float32), has)
        base = jnp.where(has[:, None], texel[:, :3], base)
        oti = m.tex_index[mid, TEX_OPACITY]
        has_otex = hit & (oti != NO_TEXTURE)
        otexel = sample_texture(scene.textures, oti, uv,
                                jnp.ones((N, 4), jnp.float32), has_otex)
        otex_alpha = jnp.where(has_otex, otexel[:, 0], 1.0)

    # headlight shading: ambient + |n·view|, plus emissive glow
    ndotv = jnp.abs(dot(n, -rd))
    shade = base * (0.25 + 0.75 * ndotv)[:, None]
    shade = shade + m.emissive[mid] * jnp.minimum(
        m.emissive_intensity[mid], 1.0)[:, None] * 0.5

    # fragment alpha (shaders.h:151-163); l = view direction in the shader
    is_transl = m.mat_type[mid] == TRANSLUCENT
    refl = m.reflectiveness[mid]
    rough = m.roughness[mid]
    ndotl = jnp.maximum(dot(n, -rd), 0.0)
    spec_fact = jnp.power(ndotl, 128.0 * (1.0 - rough)) * ndotl
    alpha_spec = (0.3 + 0.7 * refl) + spec_fact * (0.4 + 0.6 * refl)
    alpha_tr = jnp.clip(jnp.clip(alpha_spec, 0.0, 1.0)
                        + (1.0 - m.translucency[mid]), 0.0, 1.0)
    alpha = jnp.where(is_transl, alpha_tr, 1.0) * otex_alpha

    transparent = (is_transl | has_otex) & ~highlight_mask & hit
    return shade, alpha, transparent


def preview_render(scene: Scene, camera: Camera, width: int, height: int,
                   cfg=None, highlight=None, selected=None,
                   highlight_color=(1.0, 0.65, 0.1),
                   selection_color=(1.0, 0.25, 0.1),
                   transparency_layers: int = 4):
    """Rasterizer-style preview with blended transparency.

    Returns (color f32[H,W,3], object_id i32[H,W], element_id i32[H,W]) with
    ids = -1 for background. ``highlight``/``selected``: optional
    (object_id, element_id) tuples tinted like the GL preview
    (main.cpp:2870-2898); highlighted elements draw opaque, as in the
    reference's two-pass gate (main.cpp:2924-2945).
    ``transparency_layers``: max transparent surfaces composited per pixel
    before terminating (the GL pass has no such cap; layers beyond it are
    dropped — visually negligible at the default).
    """
    from ..engine.config import RenderConfig
    if cfg is None:
        cfg = RenderConfig(width=width, height=height)

    N = width * height
    pix = jnp.arange(N, dtype=jnp.int32)
    # no DOF in the preview: zero the aperture
    cam = camera.replace(aperture=jnp.float32(0.0))
    ro, rd = generate_rays(cam, width, height, jnp.uint32(0), jnp.uint32(0),
                           pix)
    intersect = _select_intersector(scene, cfg)
    g = scene.geom

    def highlight_mask_of(idx, hit):
        mask = jnp.zeros((N,), bool)
        for target in (highlight, selected):
            if target is None:
                continue
            to, te = target
            tm = hit & (g.object_id[idx] == to)
            if te is not None:
                tm = tm & (g.element_id[idx] == te)
            mask = mask | tm
        return mask

    # ---- front-to-back depth peel -----------------------------------------
    color = jnp.zeros((N, 3), jnp.float32)
    weight = jnp.ones((N,), jnp.float32)   # remaining transmittance
    active = jnp.ones((N,), bool)
    t_lower = jnp.zeros((N,), jnp.float32)
    obj_id = jnp.full((N,), -1, jnp.int32)
    elem_id = jnp.full((N,), -1, jnp.int32)

    any_transparent = scene.has_translucent or scene.has_opacity_tex
    layers = (transparency_layers + 1) if any_transparent else 1

    for layer in range(layers):
        hit, idx, t, u, v = intersect(scene, ro, rd, t_lower)
        hmask = highlight_mask_of(idx, hit)
        shade, alpha, transparent = _shade_hit(scene, hit, idx, u, v, rd,
                                               hmask)
        if layer == 0:
            obj_id = jnp.where(hit, g.object_id[idx], -1)
            elem_id = jnp.where(hit, g.element_id[idx], -1)

        # last allowed layer composites opaque regardless (budget cap)
        if layer == layers - 1:
            alpha = jnp.where(hit, 1.0, alpha)
            transparent = jnp.zeros_like(transparent)

        contribute = active & hit
        a = jnp.where(transparent, alpha, 1.0)
        color = color + jnp.where(contribute[:, None],
                                  (weight * a)[:, None] * shade, 0.0)
        weight = jnp.where(contribute & transparent,
                           weight * (1.0 - alpha), weight)
        active = contribute & transparent
        t_lower = jnp.where(active, t, t_lower)

    def tint(color, target, tint_rgb, amount):
        if target is None:
            return color
        to, te = target
        mask = (obj_id == to)
        if te is not None:
            mask = mask & (elem_id == te)
        return jnp.where(mask[:, None],
                         color * (1 - amount)
                         + jnp.asarray(tint_rgb, jnp.float32) * amount,
                         color)

    color = tint(color, highlight, highlight_color, 0.35)
    color = tint(color, selected, selection_color, 0.5)
    color = jnp.where((obj_id >= 0)[:, None], color, jnp.zeros_like(color))

    return (color.reshape(height, width, 3),
            obj_id.reshape(height, width),
            elem_id.reshape(height, width))


def pick(object_ids, element_ids, x: int, y: int):
    """Mouse-pick readback parity (main.cpp:3239-3247): returns
    (object_id, element_id) at pixel (x, y), or (-1, -1) for background."""
    import numpy as np
    oid = int(np.asarray(object_ids)[y, x])
    eid = int(np.asarray(element_ids)[y, x])
    return oid, eid
