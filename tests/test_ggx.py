"""GGX microfacet lobe (ops/ggx.py, cfg.brdf="ggx").

Validates the sampler math (unit directions, horizon clipping, energy
bound), that the option changes only opaque-specular lanes, and — the
point of GGX — that roughness pixel-gradients match
central finite differences, which the reference cone lobe cannot do
(its roughness FD is hit-flip noise)."""

import numpy as np
import jax
import jax.numpy as jnp

from pbrpathtracer_tpu.scene.builders import cornell_spheres_scene
from pbrpathtracer_tpu.scene.scene import Camera
from pbrpathtracer_tpu.engine.config import RenderConfig
from pbrpathtracer_tpu.ops.integrator import render
from pbrpathtracer_tpu.ops.ggx import ggx_sample, orthonormal_basis
from pbrpathtracer_tpu.diff.params import get_params
from pbrpathtracer_tpu.diff.loss import l2_image_loss, finite_difference_grad

CAM = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                  up=(0, 1, 0), fovy=61)


def _dirs(n, seed):
    rs = np.random.RandomState(seed)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_orthonormal_basis():
    n = jnp.asarray(_dirs(512, 0))
    t, b = orthonormal_basis(n)
    for x, y in [(t, b), (t, n), (b, n)]:
        assert np.abs(np.asarray(jnp.sum(x * y, -1))).max() < 1e-5
    assert np.abs(np.asarray(jnp.linalg.norm(t, axis=-1)) - 1).max() < 1e-5
    assert np.abs(np.asarray(jnp.linalg.norm(b, axis=-1)) - 1).max() < 1e-5
    # right-handed: cross(t, b) == n
    assert np.abs(np.asarray(jnp.cross(t, b) - n)).max() < 1e-4


def test_ggx_sample_contract():
    N = 4096
    rs = np.random.RandomState(1)
    n = jnp.asarray(np.tile(np.array([[0, 1, 0]], np.float32), (N, 1)))
    # incoming rays from the upper hemisphere pointing down at the surface
    rd = _dirs(N, 2)
    rd[:, 1] = -np.abs(rd[:, 1]) - 0.1
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))
    u1 = jnp.asarray(rs.uniform(0, 1, N).astype(np.float32))
    u2 = jnp.asarray(rs.uniform(0, 1, N).astype(np.float32))
    for rough in (0.0, 0.2, 0.7, 1.0):
        l, w = ggx_sample(rd, n, jnp.full((N,), rough, jnp.float32), u1, u2)
        l, w = np.asarray(l), np.asarray(w)
        assert np.isfinite(l).all() and np.isfinite(w).all()
        assert np.abs(np.linalg.norm(l, axis=-1) - 1).max() < 1e-4
        live = w > 0
        # horizon clipping: weighted samples are strictly above the surface
        assert (l[live][:, 1] > 0).all()
        # at roughness 1 with grazing views ~half the NDF samples fail
        # the horizon test — that's the estimator, not a bug
        assert live.mean() > 0.3
        # energy: E[w] over NDF samples = GGX directional albedo at F=1,
        # ≤ 1 (individual weights are unbounded at grazing — NDF, not
        # VNDF, sampling; the mean is the physical bound)
        assert w.mean() < 1.05
        if rough == 0.0:
            # near-mirror: sampled dir ~= reflect(rd, n)
            refl = np.asarray(rd) - 2 * (np.asarray(rd) @ np.array(
                [0, 1, 0.], np.float32))[:, None] * np.array(
                [0, 1, 0.], np.float32)
            assert np.abs(l[live] - refl[live]).max() < 0.05
            assert np.abs(w[live] - 1.0).max() < 0.05  # G2·vh/(cv·ch) → 1


def test_ggx_render_differs_only_with_specular():
    cfg = RenderConfig(width=24, height=24, max_depth=3, spp=2, seed=5)
    scene = cornell_spheres_scene(n_seg=6)
    a = np.asarray(jax.jit(lambda: render(scene, CAM, cfg))())
    b = np.asarray(jax.jit(
        lambda: render(scene, CAM, cfg.replace(brdf="ggx")))())
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() > 1e-4  # glossy spheres actually changed


def test_ggx_sampler_grad_matches_fd():
    """ops/ggx.py is smooth in roughness: AD of a scalar of (l, w) matches
    central FD tightly (the reference cone's w-warp is a step here)."""
    N = 1024
    rs = np.random.RandomState(7)
    n = jnp.asarray(_dirs(N, 8) * np.array([1, 1, 1], np.float32))
    rd = _dirs(N, 9)
    # force rays into the hemisphere opposite n
    rd = rd - 2 * np.maximum(np.sum(rd * np.asarray(n), -1),
                             0)[:, None] * np.asarray(n)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))
    u1 = jnp.asarray(rs.uniform(0.05, 0.95, N).astype(np.float32))
    u2 = jnp.asarray(rs.uniform(0, 1, N).astype(np.float32))
    probe = jnp.asarray(_dirs(N, 10))

    def f(rough, mask):
        l, w = ggx_sample(rd, n, jnp.full((N,), rough, jnp.float32), u1, u2)
        return jnp.sum(jnp.sum(l * probe, -1) * w * mask) / N

    for rough in (0.15, 0.45, 0.8):
        # freeze a safe-margin live mask at the base roughness: samples near
        # the horizon flip their ok-gate discretely under perturbation (a
        # genuine discontinuity of the clipped estimator, not of the math
        # being checked here)
        l0, w0 = ggx_sample(rd, n, jnp.full((N,), rough, jnp.float32),
                            u1, u2)
        cos_l0 = jnp.sum(l0 * n, -1)
        mask = ((w0 > 0) & (cos_l0 > 0.05)).astype(jnp.float32)
        ad = float(jax.grad(f)(jnp.float32(rough), mask))
        eps = 1e-3
        fd = (float(f(jnp.float32(rough + eps), mask))
              - float(f(jnp.float32(rough - eps), mask))) / (2 * eps)
        assert abs(ad - fd) <= 2e-2 * max(abs(ad), abs(fd)) + 1e-4, (
            f"rough={rough}: AD={ad:.6g} FD={fd:.6g}")


def _uniform_emissive_glossy_scene():
    """Glossy floor inside a uniformly EMISSIVE box: the GGX lobe sees the
    same radiance in every direction, so the roughness gradient flows only
    through the continuous throughput weight — the hit-region boundary
    term (which pathwise AD detaches, like every differentiable renderer
    without edge sampling) vanishes by construction."""
    from pbrpathtracer_tpu.scene.builders import _quad, _assemble
    from pbrpathtracer_tpu.scene.scene import MaterialSpec
    # PURE emitters (diffuse 0): wall radiance is exactly the emitted term,
    # identical on every wall — crossing a seam is not a jump, so the only
    # residual discontinuity is rare horizon clipping
    wall = MaterialSpec(diffuse=(0.0, 0.0, 0.0), emissive=(1.0, 1.0, 1.0),
                        emissive_intensity=0.6, specular=(0, 0, 0))
    # roughness 0.15: the lobe stays well inside the horizon at this
    # camera pitch, so the clipping gate never flips under the FD probe
    floor = MaterialSpec(diffuse=(0.2, 0.2, 0.2), specular=(0.9, 0.9, 0.9),
                         roughness=0.15, reflectiveness=1.0)
    groups = [
        (_quad((-1, -1, 0), (-1, -1, 4), (1, -1, 4), (1, -1, 0)), 1),  # floor
        (_quad((-1, 1, 0), (1, 1, 0), (1, 1, 4), (-1, 1, 4)), 0),      # ceil
        (_quad((-1, -1, 4), (-1, 1, 4), (1, 1, 4), (1, -1, 4)), 0),    # back
        (_quad((-1, -1, 0), (-1, 1, 0), (-1, 1, 4), (-1, -1, 4)), 0),  # left
        (_quad((1, -1, 0), (1, -1, 4), (1, 1, 4), (1, 1, 0)), 0),      # right
        (_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)), 0),    # front
    ]
    return _assemble(groups, [wall, floor])


def test_ggx_roughness_grad_matches_fd_uniform_env():
    """Render-level roughness FD vs AD with the boundary term designed out
    (uniform emissive environment): the continuous GGX chain must match."""
    scene = _uniform_emissive_glossy_scene()
    cam = Camera.make(pos=(0, 0.2, 0.3), dir=(0, -0.6, 1), up=(0, 1, 0),
                      fovy=55)
    # depth 3: wall emission is collected at depth 2 (before the RR gate,
    # whose survive-prob is max(diffuse)=0 for the pure emitters) and the
    # zero-diffuse walls terminate paths by throughput, not by RR
    cfg = RenderConfig(width=16, height=16, max_depth=3, spp=2, seed=3,
                       brdf="ggx")
    target = jnp.asarray(
        np.asarray(jax.jit(lambda: render(scene, cam, cfg))()) * 0.8)
    params = get_params(scene, cam, materials=True)
    lossf = jax.jit(lambda p: l2_image_loss(p, scene, cam, cfg, target))
    gradf = jax.jit(jax.grad(
        lambda p: l2_image_loss(p, scene, cam, cfg, target)))
    idx = [1]   # the glossy floor material
    ad = np.asarray(gradf(params)["mat.roughness"]).reshape(-1)
    fd = finite_difference_grad(lossf, params, "mat.roughness", eps=2e-3,
                                indices=idx).reshape(-1)
    for i in idx:
        err = abs(ad[i] - fd[i])
        assert abs(fd[i]) > 1e-7  # the probe actually sees the floor
        assert err <= 5e-2 * max(abs(fd[i]), abs(ad[i])) + 1e-5, (
            f"roughness[{i}]: AD={ad[i]:.6g} FD={fd[i]:.6g}")
