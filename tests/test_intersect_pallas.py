"""Pallas closest-hit kernel (kernels/intersect_pallas.py) against the plain
``intersect_classic`` reference.

On the CPU the kernel runs through the Pallas interpreter
(``interpret=True``); the same cases run compiled on a GPU in the
``gpu``-marked test (chip_smoke.py phase 7). Both sides are fp32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrpathtracer_tpu.kernels.intersect_pallas import (BLOCK_RAYS,
                                                        chunk_tables,
                                                        intersect_pallas)
from pbrpathtracer_tpu.ops.intersect import intersect_classic
from pbrpathtracer_tpu.scene.big_scenes import mesh_scene
from pbrpathtracer_tpu.scene.builders import cornell_box
from pbrpathtracer_tpu.scene.scene import pack_geometry


def _rays(n, seed, center=(0.0, 0.0, 0.3), spread=0.5):
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-spread, spread, (n, 3)).astype(np.float32) + np.asarray(
        center, np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    rd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


def _degenerate_scene():
    """Cornell box plus zero-area and collinear triangles."""
    g = cornell_box().geom
    v0, v1, v2 = (np.asarray(x) for x in g.vertices())
    p = np.array([[0.1, 0.1, 0.5]], np.float32)
    bad_v0 = np.concatenate([p, p, p])
    bad_v1 = np.concatenate([p, p + 0.1, p])
    bad_v2 = np.concatenate([p, p + 0.2, p + [[0.0, 0.1, 0.0]]])
    return pack_geometry({"v0": np.concatenate([v0, bad_v0]),
                          "v1": np.concatenate([v1, bad_v1]),
                          "v2": np.concatenate([v2, bad_v2])})


def _case(name):
    """(geometry or scene, ro, rd, t_lower, alive) for one case."""
    if name == "cornell":
        return (cornell_box(), *_rays(256, 0), None, None)
    if name == "multi_chunk":        # 600 triangles: dozens of chunks
        scene = mesh_scene(600, accel=None)
        ro, rd = _rays(200, 1, center=(0.2, 0.6, -1.5), spread=0.3)
        rd = rd.at[:, 2].set(jnp.abs(rd[:, 2]))
        return (scene, ro, rd, None, None)
    if name == "t_lower":            # opacity re-trace past a first hit
        scene = cornell_box()
        ro, rd = _rays(256, 2)
        t0 = np.asarray(intersect_classic(scene.geom, ro, rd)[2])
        return (scene, ro, rd, jnp.asarray(t0 * 1.0001), None)
    if name == "alive_mask":
        ro, rd = _rays(256, 3)
        alive = jnp.asarray(np.random.RandomState(3).uniform(size=256) > 0.4)
        return (cornell_box(), ro, rd, None, alive)
    if name == "all_dead":
        ro, rd = _rays(BLOCK_RAYS, 4)
        return (cornell_box(), ro, rd, None, jnp.zeros(BLOCK_RAYS, bool))
    if name == "degenerate_tris":
        return (_degenerate_scene(), *_rays(256, 5), None, None)
    if name == "ragged_count":       # not a multiple of the ray block
        return (cornell_box(), *_rays(BLOCK_RAYS + 37, 6), None, None)
    if name == "bvh_order":          # chunks in BVH depth-first order
        scene = mesh_scene(600, accel="always")
        ro, rd = _rays(200, 7, center=(0.2, 0.6, -1.5), spread=0.3)
        rd = rd.at[:, 2].set(jnp.abs(rd[:, 2]))
        return (scene, ro, rd, None, None)
    raise KeyError(name)


CASES = ["cornell", "multi_chunk", "t_lower", "alive_mask", "all_dead",
         "degenerate_tris", "ragged_count", "bvh_order"]


def _check(name, interpret):
    scene_or_geom, ro, rd, tl, alive = _case(name)
    geom = getattr(scene_or_geom, "geom", scene_or_geom)
    ref = [np.asarray(x) for x in jax.jit(
        lambda: intersect_classic(geom, ro, rd, tl, alive=alive))()]
    got = [np.asarray(x) for x in intersect_pallas(
        scene_or_geom, ro, rd, tl, alive=alive, interpret=interpret)]
    rh, ri, rt, ru, rv = ref
    gh, gi, gt, gu, gv = got
    assert gh.shape == rh.shape and gi.dtype == np.int32
    np.testing.assert_array_equal(gh, rh)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gt, rt, rtol=1e-5, atol=0)
    np.testing.assert_allclose(gu, ru, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-5)
    if alive is not None:            # dead lanes: a clean miss
        dead = ~np.asarray(alive)
        assert not gh[dead].any()
        assert (gi[dead] == 0).all() and (gt[dead] == 0).all()
    return rh


@pytest.mark.parametrize("name", CASES)
def test_kernel_interpret_matches_classic(name):
    hits = _check(name, interpret=True)
    if name not in ("all_dead",):
        assert hits.any(), "case exercises no hits"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_compiled_matches_classic(gpu, name):
    _check(name, interpret=False)


def test_kernel_refuses_cpu_without_interpret():
    """Outside interpret mode the kernel compiles for the GPU or fails —
    it never falls back to another route."""
    if jax.default_backend() == "gpu":
        pytest.skip("a GPU is present")
    ro, rd = _rays(8, 8)
    with pytest.raises(ValueError, match="interpret"):
        intersect_pallas(cornell_box(), ro, rd)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunk_tables_pad_and_bound(chunk):
    g = cornell_box().geom             # 36 triangles
    W, boxes = chunk_tables(g.v0, g.e1, g.e2, chunk)
    n_chunks = -(-36 // chunk)
    assert W.shape == (n_chunks * chunk, 16)
    assert boxes.shape == (n_chunks, 8)
    W, boxes = np.asarray(W), np.asarray(boxes)
    # padded rows are zero (degenerate: never hit)
    assert not W[36:].any()
    # every real triangle lies inside its chunk's box
    v0, v1, v2 = (np.asarray(x) for x in g.vertices())
    for k in range(36):
        lo, hi = boxes[k // chunk, 0:3], boxes[k // chunk, 4:7]
        for v in (v0[k], v1[k], v2[k]):
            assert (v >= lo).all() and (v <= hi).all()
