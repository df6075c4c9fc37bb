"""Texture-path parity vs the oracle: diffuse/emissive/roughness/metallic
overrides, normal mapping through the TBN, stochastic opacity re-tracing.
Procedural texture stacks — no image files needed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrpathtracer_tpu.scene.builders import cornell_box
from pbrpathtracer_tpu.scene.scene import (Camera, Textures, MaterialSpec,
                                           finalize_scene)
from pbrpathtracer_tpu.engine.config import RenderConfig
from pbrpathtracer_tpu.ops.integrator import render
from pbrpathtracer_tpu.oracle.cpu_oracle import Oracle
from pbrpathtracer_tpu.utils.constants import (TEX_DIFFUSE, TEX_NORMAL,
                                               TEX_EMISSIVE, TEX_ROUGHNESS,
                                               TEX_METALLIC, TEX_OPACITY)

CAM = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                  up=(0, 1, 0), fovy=61)


def _textured_cornell(slot_assignments):
    """Cornell box with procedural textures attached to the given
    material-row → {slot: tex_idx} assignments."""
    scene = cornell_box()
    rs = np.random.RandomState(0)
    checker = np.zeros((8, 8, 4), np.float32)
    checker[..., 3] = 1.0
    for i in range(8):
        for j in range(8):
            c = 0.9 if (i + j) % 2 == 0 else 0.2
            checker[i, j, :3] = (c, c * 0.8, c * 0.5)
    noise = rs.uniform(0.3, 1.0, (4, 4, 4)).astype(np.float32)
    # a tilted-normal map: constant (0.3, 0.2, 0.93)
    nmap = np.zeros((2, 2, 4), np.float32)
    nmap[..., :3] = (np.array([0.3, 0.2, 0.93]) + 1.0) / 2.0
    nmap[..., 3] = 1.0
    # opacity: half-transparent checker
    omap = np.zeros((4, 4, 4), np.float32)
    omap[..., 0] = rs.uniform(0.2, 0.9, (4, 4))

    images = [checker, noise, nmap, omap]
    ph = max(im.shape[0] for im in images)
    pw = max(im.shape[1] for im in images)
    data = np.zeros((len(images), ph, pw, 4), np.float32)
    size = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        data[k, :im.shape[0], :im.shape[1]] = im
        size[k] = (im.shape[1], im.shape[0])
    textures = Textures(data=jnp.asarray(data), size=jnp.asarray(size))

    tex_index = np.asarray(scene.materials.tex_index).copy()
    for row, slots in slot_assignments.items():
        for slot, k in slots.items():
            tex_index[row, slot] = k
    materials = scene.materials.replace(tex_index=jnp.asarray(tex_index))
    return finalize_scene(scene.geom, materials, textures)


def _compare(scene, cfg, outlier=0.01, tol=1e-3):
    img = np.asarray(jax.jit(lambda: render(scene, CAM, cfg))())
    oimg = Oracle(scene, CAM, cfg).render()
    d = np.abs(img - oimg).max(axis=-1)
    frac = (d > tol).mean()
    assert frac <= outlier, f"{frac:.3%} differ, max {d.max()}"
    return img


def test_diffuse_texture_parity_and_effect():
    scene = _textured_cornell({0: {TEX_DIFFUSE: 0}})
    cfg = RenderConfig(width=10, height=10, max_depth=2, spp=2, seed=2)
    img = _compare(scene, cfg)
    plain = np.asarray(jax.jit(
        lambda s: render(s, CAM, cfg))(cornell_box()))
    assert not np.allclose(img, plain)


def test_emissive_roughness_metallic_textures():
    scene = _textured_cornell({
        3: {TEX_EMISSIVE: 1},          # light gets noisy emission
        0: {TEX_ROUGHNESS: 1, TEX_METALLIC: 1},
    })
    # metallic texture makes walls specular: give them nonzero specular
    mats = scene.materials.replace(
        specular=jnp.ones_like(scene.materials.specular) * 0.8)
    scene = scene.replace(materials=mats)
    cfg = RenderConfig(width=10, height=10, max_depth=2, spp=2, seed=4)
    _compare(scene, cfg)


def test_normal_map_parity():
    scene = _textured_cornell({0: {TEX_NORMAL: 2}})
    cfg = RenderConfig(width=10, height=10, max_depth=2, spp=2, seed=6)
    _compare(scene, cfg)


def test_opacity_texture_parity():
    scene = _textured_cornell({4: {TEX_OPACITY: 3}})   # tall box translucent-ish
    assert scene.has_opacity_tex
    cfg = RenderConfig(width=10, height=10, max_depth=2, spp=2, seed=8)
    _compare(scene, cfg, outlier=0.02)


def test_texture_gradients_flow():
    scene = _textured_cornell({0: {TEX_DIFFUSE: 0}})
    cfg = RenderConfig(width=8, height=8, max_depth=2, spp=1, seed=3)
    from pbrpathtracer_tpu.diff.params import get_params
    from pbrpathtracer_tpu.diff.loss import l2_image_loss
    params = get_params(scene, CAM, materials=False, textures=True)
    target = jnp.zeros((8, 8, 3), jnp.float32)
    g = jax.jit(jax.grad(
        lambda p: l2_image_loss(p, scene, CAM, cfg, target)))(params)
    gt = np.asarray(g["tex.data"])
    assert np.isfinite(gt).all()
    # gradient lands on texture 0 (the used checker), not on others
    assert np.abs(gt[0]).max() > 0
    assert np.abs(gt[2]).max() == 0


def test_texture_fit_at_scale_512():
    """BASELINE config-5-style texture fit with a REAL-sized texture leaf
    (512x512x4 per texture, ~8.4 MB of texel parameters): the scatter-add
    texel VJP must produce finite grads and a decreasing loss."""
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera)
    from pbrpathtracer_tpu.diff.fit import fit

    scene = mesh_scene(n_tris=1500, textured=True, accel=None, tex_size=512)
    assert scene.textures.data.shape[1] >= 512
    mcam = mesh_scene_camera()
    cfg = RenderConfig(width=24, height=24, max_depth=2, spp=1, seed=1)
    target = np.full((24, 24, 3), 0.28, np.float32)
    res = fit(scene, mcam, cfg, target, steps=4, lr=5e-2,
              materials=False, textures=True, sample_offset_per_step=False)
    assert len(res.losses) == 4
    assert all(np.isfinite(res.losses))
    # deterministic seed (no per-step resample) => monotone-ish descent
    assert res.losses[-1] < res.losses[0], res.losses
    gtex = np.asarray(res.params["tex.data"])
    assert gtex.shape[1:] == (512, 512, 4)
    assert np.isfinite(gtex).all()
    # the fit actually moved texels (non-trivial update through scatter-add)
    base = np.asarray(scene.textures.data)
    assert np.abs(gtex - base).max() > 1e-4
