"""Deep parity stress: depth >= 4 with opacity + normal
+ roughness textures *simultaneously* and >= 2 stacked opacity layers, so a
single closest-hit query can burn multiple stochastic-alpha re-trace
attempts (ops/hit.py) — probing the keyed-slot bookkeeping and the bounded
force-accept at the opacity_attempts budget against the CPU oracle
(Hit, pathtracer.cpp:463-488 draws one Rand() per visited candidate leaf).
"""

import numpy as np
import jax
import jax.numpy as jnp

from pbrpathtracer_tpu.scene.builders import cornell_box, _quad, _merge_into
from pbrpathtracer_tpu.scene.scene import (Camera, MaterialSpec, Textures,
                                           finalize_scene)
from pbrpathtracer_tpu.engine.config import RenderConfig
from pbrpathtracer_tpu.ops.integrator import render
from pbrpathtracer_tpu.oracle.cpu_oracle import Oracle
from pbrpathtracer_tpu.utils.constants import (TEX_DIFFUSE, TEX_NORMAL,
                                               TEX_OPACITY, TEX_ROUGHNESS)

CAM = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                  up=(0, 1, 0), fovy=61)


def curtained_cornell():
    """Cornell box + two semi-transparent 'curtain' quads spanning the room
    between the camera and the boxes. Every primary ray crosses BOTH
    curtains, so closest-hit queries routinely reject 1-2 candidates before
    settling — multi-layer stochastic alpha on the bounce AND shadow paths.

    Texture load-out (all slots live at once):
      * curtains: opacity checker + tilted normal map + diffuse checker
      * tall box (mat 4): roughness texture + reflectiveness 0.5 so the
        glossy-cone lobe consumes the textured roughness at depth.
    """
    scene = cornell_box()
    curtain = MaterialSpec(diffuse=(0.85, 0.8, 0.7), specular=(0, 0, 0))
    extra = [
        (_quad((-1, -1, 1.2), (-1, 1, 1.2), (1, 1, 1.2), (1, -1, 1.2)), 6),
        (_quad((-1, -1, 1.6), (1, -1, 1.6), (1, 1, 1.6), (-1, 1, 1.6)), 7),
    ]
    scene = _merge_into(scene, extra, [curtain, curtain])

    rs = np.random.RandomState(2)
    checker = np.zeros((8, 8, 4), np.float32)
    checker[..., 3] = 1.0
    for i in range(8):
        for j in range(8):
            c = 0.9 if (i + j) % 2 == 0 else 0.3
            checker[i, j, :3] = (c, c * 0.85, c * 0.6)
    # opacity in the red channel (Image::tex2D reads .r, pathtracer.cpp:471)
    omap = np.zeros((4, 4, 4), np.float32)
    omap[..., 0] = rs.uniform(0.25, 0.85, (4, 4))
    nmap = np.zeros((2, 2, 4), np.float32)
    nmap[..., :3] = (np.array([0.25, 0.15, 0.95]) + 1.0) / 2.0
    nmap[..., 3] = 1.0
    rough = np.zeros((4, 4, 4), np.float32)
    rough[..., 0] = rs.uniform(0.1, 0.9, (4, 4))

    images = [checker, omap, nmap, rough]
    ph = max(im.shape[0] for im in images)
    pw = max(im.shape[1] for im in images)
    data = np.zeros((len(images), ph, pw, 4), np.float32)
    size = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        data[k, :im.shape[0], :im.shape[1]] = im
        size[k] = (im.shape[1], im.shape[0])
    textures = Textures(data=jnp.asarray(data), size=jnp.asarray(size))

    tex_index = np.asarray(scene.materials.tex_index).copy()
    for row in (6, 7):
        tex_index[row, TEX_DIFFUSE] = 0
        tex_index[row, TEX_OPACITY] = 1
        tex_index[row, TEX_NORMAL] = 2
    tex_index[4, TEX_ROUGHNESS] = 3
    refl = np.asarray(scene.materials.reflectiveness).copy()
    refl[4] = 0.5
    materials = scene.materials.replace(
        tex_index=jnp.asarray(tex_index), reflectiveness=jnp.asarray(refl))
    return finalize_scene(scene.geom, materials, textures)


def _compare(scene, cfg, outlier=0.02, tol=1e-3):
    img = np.asarray(jax.jit(lambda: render(scene, CAM, cfg))())
    oimg = Oracle(scene, CAM, cfg).render()
    d = np.abs(img - oimg).max(axis=-1)
    frac = (d > tol).mean()
    assert frac <= outlier, f"{frac:.3%} pixels differ > {tol}, max {d.max()}"
    ok = d <= tol
    assert d[ok].mean() < 1e-4
    return img


def test_deep_opacity_stack_parity():
    """Depth-5 parity with all texture machinery engaged at once."""
    scene = curtained_cornell()
    assert scene.has_opacity_tex
    cfg = RenderConfig(width=10, height=10, max_depth=5, spp=2, seed=9)
    img = _compare(scene, cfg)
    assert img.max() > 0.05          # light reaches the camera through layers


def test_forced_accept_boundary_parity():
    """opacity_attempts=2 with two stacked layers: queries regularly exhaust
    the re-trace budget and force-accept (ops/hit.py) — the oracle applies
    the identical rule, so parity must hold AT the boundary too."""
    scene = curtained_cornell()
    cfg = RenderConfig(width=10, height=10, max_depth=4, spp=2, seed=4,
                       opacity_attempts=2)
    _compare(scene, cfg)

    # The cap must actually bind in this scene (else the test is vacuous):
    # a larger budget changes the image.
    img2 = np.asarray(jax.jit(
        lambda: render(scene, CAM, cfg))())
    img4 = np.asarray(jax.jit(
        lambda: render(scene, CAM, cfg.replace(opacity_attempts=4)))())
    assert not np.allclose(img2, img4), \
        "opacity budget never exhausted — stress scene too thin"
