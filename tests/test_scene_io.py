"""Scene I/O: OBJ loader, editor model, .pts persistence, PNG export."""

import os
import textwrap

import numpy as np
import jax
import pytest

from pbrpathtracer_tpu.scene.obj_loader import (load_object_triangles,
                                                object_name_from_path,
                                                parse_obj)
from pbrpathtracer_tpu.scene.editor import EditorScene
from pbrpathtracer_tpu.scene.scene import MaterialSpec
from pbrpathtracer_tpu.scene.pts import (compare_versions, load_pts, save_pts,
                                         get_resolution_from_scene_file,
                                         PtsError)
from pbrpathtracer_tpu.utils.constants import TRANSLUCENT

CUBE_OBJ = textwrap.dedent("""\
    # simple cube-ish: two quads as two elements
    o floor
    v -1 0 -1
    v 1 0 -1
    v 1 0 1
    v -1 0 1
    vt 0 0
    vt 1 0
    vt 1 1
    vt 0 1
    vn 0 1 0
    f 1/1/1 2/2/1 3/3/1 4/4/1
    o wall
    v -1 0 -1
    v -1 2 -1
    v 1 2 -1
    v 1 0 -1
    s 1
    f 5/1/1 6/2/1 7/3/1 8/4/1
    """)


@pytest.fixture
def cube_path(tmp_path):
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    return str(p)


def test_parse_obj_shapes_and_triangulation(cube_path):
    obj = parse_obj(cube_path)
    assert len(obj.shapes) == 2
    assert obj.shapes[0].name == "floor"
    assert obj.shapes[1].name == "wall"
    # quads → 2 tris each (fan)
    assert len(obj.shapes[0].faces) == 2
    assert len(obj.shapes[1].faces) == 2
    # X negation on import
    assert obj.positions[0, 0] == 1.0   # was -1
    # V flip on texcoords
    assert obj.texcoords[1, 1] == 1.0   # vt 1 0 → (1, 1)


def test_smoothing_flag_per_face(cube_path):
    tris = load_object_triangles(cube_path)
    assert tris["smoothing"].tolist() == [False, False, True, True]
    assert tris["element_id"].tolist() == [0, 0, 1, 1]
    assert tris["element_names"] == ["floor", "wall"]


TENT_OBJ = textwrap.dedent("""\
    # two planes meeting at a ridge, distinct smoothing groups, no vn:
    # generated smooth normals must NOT blend across the group boundary
    o tent
    v -1 0 0
    v -1 0 1
    v 0 1 0
    v 0 1 1
    v 1 0 0
    v 1 0 1
    s 1
    f 1 2 4 3
    s 2
    f 3 4 6 5
    """)


def test_smooth_normals_per_group(tmp_path):
    """previewer.cpp:84-294 re-shapes per smoothing-group id and smooths
    within the group only; the ridge vertices shared by groups 1 and 2
    must keep each plane's own normal."""
    p = tmp_path / "tent.obj"
    p.write_text(TENT_OBJ)
    tris = load_object_triangles(str(p))
    assert tris["smoothing"].all()
    v0, v1, v2 = tris["v0"], tris["v1"], tris["v2"]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
    corners_v = [tris["v0"], tris["v1"], tris["v2"]]
    corners_n = [tris["n0"], tris["n1"], tris["n2"]]

    def ridge_normals(t):
        """Generated normals of triangle t at its ridge (y==1) corners."""
        out = []
        for c in range(3):
            if abs(corners_v[c][t][1] - 1.0) < 1e-6:
                out.append(corners_n[c][t])
        assert out
        return np.asarray(out)

    # fan order: tris 0,1 = group 1 (plane A); tris 2,3 = group 2 (plane B)
    for t in range(4):
        for n in ridge_normals(t):
            # each ridge normal aligns with ITS OWN plane's face normal
            assert abs(abs(np.dot(n, fn[t])) - 1.0) < 1e-5
    # and the two groups disagree across the boundary
    nA, nB = ridge_normals(0)[0], ridge_normals(2)[0]
    assert np.linalg.norm(nA - nB) > 0.5


def test_object_name_from_path():
    assert object_name_from_path("/a/b/monkey.obj") == "monkey"
    assert object_name_from_path("monkey.obj") == "monkey"


def test_model_matrix_bake(cube_path):
    M = np.eye(4, dtype=np.float32)
    M[0, 3] = 5.0   # translate x+5
    tris = load_object_triangles(cube_path, M)
    base = load_object_triangles(cube_path)
    assert np.allclose(tris["v0"][:, 0], base["v0"][:, 0] + 5.0)
    # normals unaffected by translation (w=0)
    assert np.allclose(tris["n0"], base["n0"])


def test_editor_trs_and_build(cube_path):
    ed = EditorScene()
    assert ed.load_object(cube_path)
    ed.set_location(0, (1.0, 2.0, 3.0))
    ed.set_rotation(0, (0.0, np.pi / 2, 0.0))
    ed.set_scale_direct(0, (2.0, 2.0, 2.0))
    ed.set_material(0, 0, MaterialSpec(diffuse=(1, 0, 0)))
    scene = ed.build_scene()
    assert scene.num_triangles == 4
    assert np.asarray(scene.materials.diffuse)[0].tolist() == [1, 0, 0]
    # M = T·Ry·S: obj-space (after -X flip) corner (1,0,-1)→ scale (2,0,-2)
    # → rotY90 (x,z)=(z,-x)... verify via matrix directly
    M = ed.objects[0].matrix()
    v = M @ np.array([1, 0, 1, 1], np.float32)
    assert np.allclose(v[:3], [1 + 2.0, 2.0, 3 - 2.0], atol=1e-5)


def test_editor_scale_lock():
    ed = EditorScene()
    ed.objects.append(__import__(
        "pbrpathtracer_tpu.scene.editor", fromlist=["EditorObject"]
    ).EditorObject())
    ed.set_scale(0, (2.0, 1.0, 1.0))   # locked: doubling x doubles all
    assert ed.objects[0].scale == (2.0, 2.0, 2.0)
    ed.objects[0].scale_locked = False
    ed.set_scale(0, (2.0, 2.0, 4.0))
    assert ed.objects[0].scale == (2.0, 2.0, 4.0)


def test_editor_camera_aperture_bridge():
    ed = EditorScene()
    ed.cam_focal = 0.05
    ed.set_camera_f(25.0)
    cam = ed.tracer_camera()
    assert abs(float(cam.aperture) - 0.05 / 25.0) < 1e-9


def test_compare_versions():
    assert compare_versions("2.1.0", "2.0.0") > 0
    assert compare_versions("2.0.0", "2.0.0") == 0
    assert compare_versions("1.9.9", "2.0.0") < 0


def test_pts_roundtrip(tmp_path, cube_path):
    ed = EditorScene()
    ed.load_object(cube_path)
    ed.set_location(0, (1, 2, 3))
    ed.set_material(0, 1, MaterialSpec(
        mat_type=TRANSLUCENT, diffuse=(0.1, 0.2, 0.3), roughness=0.25,
        reflectiveness=0.5, translucency=0.75, ior=1.33))
    ed.set_texture(0, 1, "normal", "/tmp/nonexistent_normal.png")
    ed.set_camera((4, 5, 6))
    ed.rotate_camera((0.1, 0.2, 0.3))
    ed.set_camera_focal_dist(2.5)
    ed.set_camera_f(8.0)

    p = str(tmp_path / "scene.pts")
    save_pts(p, ed, {"trace_depth": 5, "width": 320, "height": 240,
                     "auto_res": False})

    ed2, settings = load_pts(p)
    assert settings["trace_depth"] == 5
    assert (settings["width"], settings["height"]) == (320, 240)
    assert settings["auto_res"] is False
    assert len(ed2.objects) == 1
    assert ed2.objects[0].location == (1.0, 2.0, 3.0)
    m = ed2.objects[0].elements[1].material
    assert m.mat_type == TRANSLUCENT
    assert abs(m.translucency - 0.75) < 1e-6
    assert abs(m.ior - 1.33) < 1e-6
    assert ed2.objects[0].elements[1].texture_paths[1] == \
        "/tmp/nonexistent_normal.png"
    assert np.allclose(ed2.cam_pos, [4, 5, 6])
    assert ed2.cam_f == 8.0
    assert get_resolution_from_scene_file(p) == (320, 240)


def test_pts_version_gate(tmp_path):
    p = tmp_path / "old.pts"
    p.write_text("Path Tracer Scene File\nVersion=1.0.0\n3\n")
    with pytest.raises(PtsError):
        load_pts(str(p))
    p2 = tmp_path / "notascene.pts"
    p2.write_text("hello\n")
    with pytest.raises(PtsError):
        load_pts(str(p2))


def test_pts_missing_object_redirection(tmp_path, cube_path):
    ed = EditorScene()
    ed.load_object(cube_path)
    p = str(tmp_path / "scene.pts")
    save_pts(p, ed)
    # break the path, then redirect
    moved = str(tmp_path / "moved.obj")
    os.rename(cube_path, moved)
    ed2, settings = load_pts(p)
    assert settings["missing_objects"] == [cube_path]
    ed3 = EditorScene()
    ed3.redirect(cube_path, moved)
    ed3, settings = load_pts(p, editor=ed3)
    assert settings["missing_objects"] == []
    assert ed3.build_scene().num_triangles == 4


def test_obj_scene_end_to_end_render(tmp_path, cube_path):
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.ops.integrator import render

    ed = EditorScene()
    ed.load_object(cube_path)
    ed.set_material(0, 0, MaterialSpec(diffuse=(0.6, 0.6, 0.6),
                                       specular=(0, 0, 0)))
    ed.set_material(0, 1, MaterialSpec(
        diffuse=(0.7, 0.7, 0.7), emissive=(1.0, 0.9, 0.8),
        emissive_intensity=2.0, specular=(0, 0, 0)))
    ed.set_camera((0.1, 1.0, 4.0), dir=(0, -0.2, -1), up=(0, 1, 0))
    scene = ed.build_scene()
    assert scene.num_lights == 2
    cfg = RenderConfig(width=12, height=12, max_depth=2, spp=2, seed=1)
    img = np.asarray(jax.jit(
        lambda: render(scene, ed.tracer_camera(), cfg))())
    assert np.isfinite(img).all()
    assert img.max() > 0.1    # emissive wall visible


def test_png_export(tmp_path):
    from pbrpathtracer_tpu.io.png import export_png, auto_filename
    img = np.random.RandomState(0).uniform(0, 2, (8, 8, 3)).astype(np.float32)
    p = export_png(str(tmp_path / "out.png"), img)
    from PIL import Image
    arr = np.asarray(Image.open(p))
    assert arr.shape == (8, 8, 3)
    assert arr.max() <= 255 and arr.dtype == np.uint8
    # truncation (not rounding) parity
    expect = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(arr, expect)
    import datetime
    name = auto_filename(".", datetime.datetime(2026, 8, 17, 7, 5, 9))
    assert name.endswith("scene_20260817_7_5_9.png")
