"""Choice of the closest-hit route (ops/hit._resolve_intersector_name) by
backend and triangle count, and the auto-policies of RenderConfig."""

import pytest

from pbrpathtracer_tpu.engine.config import RenderConfig
from pbrpathtracer_tpu.ops.hit import _resolve_intersector_name


class _Scene:
    """Just what the resolver reads."""

    def __init__(self, num_triangles, accel):
        self.num_triangles = num_triangles
        self.accel = accel


@pytest.mark.parametrize("backend,tris,has_bvh,expected", [
    ("gpu", 36, False, "pallas"),
    ("gpu", 4096, True, "pallas"),        # at the threshold: dense
    ("gpu", 4097, True, "bvh"),
    ("gpu", 1_000_000, False, "pallas"),  # no BVH built: dense
    ("cpu", 36, False, "matmul"),
    ("cpu", 4097, True, "bvh"),
    ("cpu", 4097, False, "matmul"),
])
def test_auto_route(backend, tris, has_bvh, expected):
    scene = _Scene(tris, object() if has_bvh else None)
    assert _resolve_intersector_name(scene, RenderConfig(),
                                     backend=backend) == expected


@pytest.mark.parametrize("name", ["matmul", "classic", "pallas", "bvh"])
@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_explicit_route_wins(name, backend):
    scene = _Scene(100_000, object())
    cfg = RenderConfig(intersector=name)
    assert _resolve_intersector_name(scene, cfg, backend=backend) == name


def test_threshold_is_configurable():
    scene = _Scene(2000, object())
    cfg = RenderConfig(bvh_threshold=1000)
    assert _resolve_intersector_name(scene, cfg, backend="gpu") == "bvh"


def test_auto_policies_resolve_to_constants():
    cfg = RenderConfig()
    assert cfg.unroll_segments == 1
    assert cfg.pixel_order == "scan"
    assert cfg.compact_wavefront == "off"
    assert cfg.resolved_remat(cfg.unroll_segments, _Scene(36, None)) \
        == "hits"
    full = cfg.resolved_max_segments()
    assert cfg.replace(unroll_segments=full).resolved_remat(
        full, _Scene(36, None)) == "off"
    with pytest.raises(ValueError):
        cfg.replace(compact_wavefront="bogus")
    with pytest.raises(ValueError):
        cfg.replace(pixel_order="auto")
