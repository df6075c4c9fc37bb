"""Scene-as-arrays: the functional core datamodel of the renderer.

The reference keeps its scene as ``std::vector<Triangle>`` with per-triangle
``Material*`` pointers resolved through ``(objectId, elementId)``
(pathtracer.h:51-56, mesh.h:71-96). Here the scene is a JAX pytree of flat
SoA arrays: triangles reference a flattened material table via ``mat_id`` and
materials reference a padded texture stack via ``tex_index``. Everything a
user might optimize (material params, textures, lights implicitly through
emissive, camera lens params) is a differentiable leaf.

Parity notes are cited per field against /root/reference/PathTracing/src/.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.constants import (
    EPS,
    NUM_TEX_SLOTS,
    NO_TEXTURE,
    OPAQUE,
)
from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Geometry:
    """Triangle soup with baked model matrices (pathtracer.cpp:41-145).

    Vertices are stored as (v0, e1, e2) with e1 = v1 - v0, e2 = v2 - v0 —
    the Möller–Trumbore edge form (pathtracer.cpp:379-383) — so the hot
    intersector never recomputes edges.
    """

    v0: jnp.ndarray        # f32[T,3]
    e1: jnp.ndarray        # f32[T,3]
    e2: jnp.ndarray        # f32[T,3]
    n0: jnp.ndarray        # f32[T,3] per-vertex shading normals (may be zero)
    n1: jnp.ndarray        # f32[T,3]
    n2: jnp.ndarray        # f32[T,3]
    uv0: jnp.ndarray       # f32[T,2]
    uv1: jnp.ndarray       # f32[T,2]
    uv2: jnp.ndarray       # f32[T,2]
    normal: jnp.ndarray    # f32[T,3] geometric normal = normalize(e1 x e2) (mesh.cpp:78)
    tangent: jnp.ndarray   # f32[T,3] from UV deltas (mesh.cpp:70-72)
    bitangent: jnp.ndarray  # f32[T,3] (mesh.cpp:74-76)
    smoothing: jnp.ndarray  # bool[T] smoothing-group flag (pathtracer.cpp:131-135)
    mat_id: jnp.ndarray    # i32[T] index into the material table
    object_id: jnp.ndarray  # i32[T] (pathtracer.cpp:137)
    element_id: jnp.ndarray  # i32[T] (pathtracer.cpp:138)

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def vertices(self):
        """Return (v0, v1, v2) actual vertex positions."""
        return self.v0, self.v0 + self.e1, self.v0 + self.e2


@pytree_dataclass
class Materials:
    """Flattened (object, element) material table (mesh.h:21-59).

    ``reflectiveness`` is the reference's name for metallic; the metallic
    texture overrides it (pathtracer.cpp:582-584).
    """

    mat_type: jnp.ndarray            # i32[M] 0=OPAQUE 1=TRANSLUCENT (mesh.h:15-19)
    diffuse: jnp.ndarray             # f32[M,3]
    specular: jnp.ndarray            # f32[M,3]
    emissive: jnp.ndarray            # f32[M,3]
    emissive_intensity: jnp.ndarray  # f32[M]
    roughness: jnp.ndarray           # f32[M]
    reflectiveness: jnp.ndarray      # f32[M]
    translucency: jnp.ndarray        # f32[M]
    ior: jnp.ndarray                 # f32[M]
    tex_index: jnp.ndarray           # i32[M,6] texture-stack index per slot, -1 = none

    @property
    def num_materials(self) -> int:
        return self.diffuse.shape[0]


@pytree_dataclass
class Textures:
    """Padded texture stack.

    The reference stores each texture as an RGBA8 buffer ≤1024² sampled
    nearest-neighbor with repeat wrap (image.cpp:63-86). Here all textures
    live in one f32 stack padded to a common (H, W) so a single dynamic
    gather serves every fetch; ``size`` carries the true per-texture
    dimensions for the wrap arithmetic. Values are p/255 floats, i.e. exactly
    the reference's ``tex2D`` output for u8 sources, but kept continuous so
    texture gradients exist.
    """

    data: jnp.ndarray   # f32[K, PH, PW, 4]
    size: jnp.ndarray   # i32[K, 2] = (width, height)

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


@pytree_dataclass
class Camera:
    """Pinhole + thin-lens camera (pathtracer.cpp:17-22, 333-360, 756-791).

    ``aperture = focal / F`` is set by the editor bridge
    (previewer.cpp:924-930); ``focal_dist`` and ``aperture`` are
    differentiable lens parameters.
    """

    pos: jnp.ndarray         # f32[3]
    dir: jnp.ndarray         # f32[3] normalized
    up: jnp.ndarray          # f32[3] normalized
    focal: jnp.ndarray       # f32[] image-plane distance (default 0.1)
    fovy: jnp.ndarray        # f32[] degrees (default 90)
    focal_dist: jnp.ndarray  # f32[] thin-lens focus distance (default 5)
    aperture: jnp.ndarray    # f32[] lens radius scale (default 0)

    @classmethod
    def make(cls, pos=(0.0, 0.0, 0.0), dir=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
             focal=0.1, fovy=90.0, focal_dist=5.0, aperture=0.0):
        f32 = jnp.float32
        d = jnp.asarray(dir, f32)
        u = jnp.asarray(up, f32)
        return cls(
            pos=jnp.asarray(pos, f32),
            dir=d / jnp.linalg.norm(d),
            up=u / jnp.linalg.norm(u),
            focal=f32(focal), fovy=f32(fovy),
            focal_dist=f32(focal_dist), aperture=f32(aperture),
        )


@pytree_dataclass
class Scene:
    """Complete render-ready scene.

    ``lights`` holds indices of emissive triangles in scene order, built the
    same way as PathTracer::BuildBVH's light pass: a triangle is a light iff
    ``||material.emissive|| >= EPS`` (pathtracer.cpp:267-273).
    """

    geom: Geometry
    materials: Materials
    textures: Textures
    lights: jnp.ndarray   # i32[L] triangle indices (L may be 0)
    # Optional acceleration structure (accel.build.FlatBVH); None = dense
    # intersectors only.
    accel: object = None
    # Static metadata (not traced):
    has_opacity_tex: bool = static_field(False)
    has_any_texture: bool = static_field(False)
    # Any TRANSLUCENT material present (preview transparency pass gate).
    has_translucent: bool = static_field(False)

    @property
    def num_triangles(self) -> int:
        return self.geom.num_triangles

    @property
    def num_lights(self) -> int:
        return self.lights.shape[0]


# ---------------------------------------------------------------------------
# Host-side construction helpers (numpy; used by builders and loaders)
# ---------------------------------------------------------------------------

def compute_tbn(v0, v1, v2, uv0, uv1, uv2):
    """Vectorized Triangle::Init (mesh.cpp:61-83).

    Returns (normal, tangent, bitangent), each f32[T,3], normalized. The
    reference does not guard the ``1/det(UV)`` division; we zero the
    tangent/bitangent for degenerate UVs instead of producing NaN — a
    documented deviation that only affects normal mapping on triangles whose
    UVs the reference would NaN on anyway.
    """
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    d1 = np.asarray(uv1, np.float32) - np.asarray(uv0, np.float32)
    d2 = np.asarray(uv2, np.float32) - np.asarray(uv0, np.float32)

    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(np.abs(det) > 0, 1.0 / det, 0.0).astype(np.float32)

    tangent = f[:, None] * (d2[:, 1:2] * e1 - d1[:, 1:2] * e2)
    bitangent = f[:, None] * (-d2[:, 0:1] * e1 + d1[:, 0:1] * e2)
    normal = np.cross(e1, e2)

    def _norm(x):
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return np.where(n > 0, x / np.maximum(n, 1e-30), x).astype(np.float32)

    return _norm(normal), _norm(tangent), _norm(bitangent)


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description — mirrors the Material ctor defaults
    (mesh.h:41-58)."""

    mat_type: int = OPAQUE
    diffuse: tuple = (1.0, 1.0, 1.0)
    specular: tuple = (1.0, 1.0, 1.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    emissive_intensity: float = 1.0
    roughness: float = 1.0
    reflectiveness: float = 0.0
    translucency: float = 1.0
    ior: float = 1.5
    # texture-stack indices per slot, NO_TEXTURE = none
    tex_index: tuple = (NO_TEXTURE,) * NUM_TEX_SLOTS


def pack_materials(specs) -> Materials:
    """Pack a list of MaterialSpec into the Materials SoA pytree."""
    f32, i32 = np.float32, np.int32
    return Materials(
        mat_type=jnp.asarray([s.mat_type for s in specs], i32),
        diffuse=jnp.asarray([s.diffuse for s in specs], f32),
        specular=jnp.asarray([s.specular for s in specs], f32),
        emissive=jnp.asarray([s.emissive for s in specs], f32),
        emissive_intensity=jnp.asarray([s.emissive_intensity for s in specs], f32),
        roughness=jnp.asarray([s.roughness for s in specs], f32),
        reflectiveness=jnp.asarray([s.reflectiveness for s in specs], f32),
        translucency=jnp.asarray([s.translucency for s in specs], f32),
        ior=jnp.asarray([s.ior for s in specs], f32),
        tex_index=jnp.asarray([s.tex_index for s in specs], i32),
    )


def pack_geometry(tris) -> Geometry:
    """Pack host triangle dicts into the Geometry SoA pytree.

    ``tris`` is a dict of numpy arrays with keys v0,v1,v2 (f32[T,3]),
    optional n0,n1,n2, uv0,uv1,uv2, smoothing (bool[T]), mat_id, object_id,
    element_id.
    """
    T = tris["v0"].shape[0]
    f32, i32 = np.float32, np.int32
    v0 = np.asarray(tris["v0"], f32)
    v1 = np.asarray(tris["v1"], f32)
    v2 = np.asarray(tris["v2"], f32)
    zeros3 = np.zeros((T, 3), f32)
    zeros2 = np.zeros((T, 2), f32)
    n0 = np.asarray(tris.get("n0", zeros3), f32)
    n1 = np.asarray(tris.get("n1", zeros3), f32)
    n2 = np.asarray(tris.get("n2", zeros3), f32)
    uv0 = np.asarray(tris.get("uv0", zeros2), f32)
    uv1 = np.asarray(tris.get("uv1", zeros2), f32)
    uv2 = np.asarray(tris.get("uv2", zeros2), f32)
    normal, tangent, bitangent = compute_tbn(v0, v1, v2, uv0, uv1, uv2)
    return Geometry(
        v0=jnp.asarray(v0), e1=jnp.asarray(v1 - v0), e2=jnp.asarray(v2 - v0),
        n0=jnp.asarray(n0), n1=jnp.asarray(n1), n2=jnp.asarray(n2),
        uv0=jnp.asarray(uv0), uv1=jnp.asarray(uv1), uv2=jnp.asarray(uv2),
        normal=jnp.asarray(normal), tangent=jnp.asarray(tangent),
        bitangent=jnp.asarray(bitangent),
        smoothing=jnp.asarray(tris.get("smoothing", np.zeros(T, bool))),
        mat_id=jnp.asarray(tris.get("mat_id", np.zeros(T, i32)), i32),
        object_id=jnp.asarray(tris.get("object_id", np.zeros(T, i32)), i32),
        element_id=jnp.asarray(tris.get("element_id", np.zeros(T, i32)), i32),
    )


def empty_textures() -> Textures:
    """A 1-entry dummy stack so texture gathers always have a valid target."""
    return Textures(
        data=jnp.zeros((1, 1, 1, 4), jnp.float32),
        size=jnp.ones((1, 2), jnp.int32),
    )


def pack_textures(images) -> Textures:
    """Pack a list of f32[H,W,4] numpy images into a padded stack.

    Slot k of the returned stack is exactly ``images[k]`` — material
    ``tex_index`` values are absolute indices into this stack, with -1
    (NO_TEXTURE) meaning "no texture" (gathers mask on that, never on a
    dummy slot). Only when ``images`` is empty does this return the
    1-entry dummy stack from ``empty_textures`` so texture gathers always
    have a valid target array.
    """
    if not images:
        return empty_textures()
    ph = max(im.shape[0] for im in images)
    pw = max(im.shape[1] for im in images)
    data = np.zeros((len(images), ph, pw, 4), np.float32)
    size = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        h, w = im.shape[:2]
        data[k, :h, :w, :] = im
        size[k] = (w, h)
    return Textures(data=jnp.asarray(data), size=jnp.asarray(size))


def build_lights(geom: Geometry, materials: Materials) -> jnp.ndarray:
    """Light list: triangles whose material emissive has norm >= EPS, in
    triangle order (pathtracer.cpp:267-273)."""
    emissive = np.asarray(materials.emissive)
    mat_id = np.asarray(geom.mat_id)
    norms = np.linalg.norm(emissive[mat_id], axis=-1)
    idx = np.nonzero(norms >= EPS)[0].astype(np.int32)
    return jnp.asarray(idx)


def finalize_scene(geom: Geometry, materials: Materials,
                   textures: Textures | None = None,
                   accel: str | None = "auto",
                   accel_threshold: int = 4096) -> Scene:
    """Assemble a Scene: build the light list, static texture flags, and —
    for large scenes — the BVH ("auto": build when tris > accel_threshold;
    "always"/None force/skip)."""
    if textures is None:
        textures = empty_textures()
    tex_index = np.asarray(materials.tex_index)
    from ..utils.constants import TEX_OPACITY, TRANSLUCENT as TRANSLUCENT_ID
    has_opacity = bool((tex_index[:, TEX_OPACITY] >= 0).any())
    has_any = bool((tex_index >= 0).any())
    scene = Scene(
        geom=geom, materials=materials, textures=textures,
        lights=build_lights(geom, materials),
        has_opacity_tex=has_opacity, has_any_texture=has_any,
        has_translucent=bool(
            (np.asarray(materials.mat_type) == TRANSLUCENT_ID).any()),
    )
    T = geom.num_triangles
    if accel == "always" or (accel == "auto" and T > accel_threshold):
        scene = with_accel(scene)
    return scene


def with_accel(scene: Scene, leaf_size: int = 8) -> Scene:
    """Attach a BVH built from the scene geometry (C++ SAH builder for
    large scenes, numpy median-split otherwise — accel/native.py)."""
    from ..accel.native import build_bvh_auto
    v0, v1, v2 = scene.geom.vertices()
    bvh = build_bvh_auto(np.asarray(v0), np.asarray(v1), np.asarray(v2),
                         leaf_size=leaf_size)
    return scene.replace(accel=bvh)
