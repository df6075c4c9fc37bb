"""Packed per-triangle shading tables — the gather-fusion layer.

Shading one wavefront segment needs ~26 per-lane attribute lookups: nine
triangle arrays (normals, vertex normals, UVs, smoothing), ten material
fields through ``mat_id``, and seven more for NEE light sampling. This
module folds everything shading reads into two precomputed tables, so a
segment does one row fetch per table instead of 26 narrow gathers:

  * ``tri_pack`` f32[T, 55] — triangle attributes with the material row
    *pre-joined* per triangle (materials[mat_id] is itself a gather, done
    once here instead of per lane per segment);
  * ``light_pack`` f32[L, 13] — light-triangle vertices + premultiplied
    emissive color + the scene triangle id.

Both are pure functions of the Scene pytree, built inside the traced
render; XLA's loop-invariant code motion hoists them out of the bounce
scan, and reverse-mode AD routes cotangents back through the join to the
original material/geometry leaves (so texture/material optimization is
unaffected). Integer fields (mat_type, tex_index, light tri id) are stored
as exact small floats; flags as 0.0/1.0.

Replaces the scattered per-field gathers that mirrored the reference's
per-hit pointer chasing (pathtracer.cpp:549-584) with one row fetch.

For tables of at most MATMUL_SCATTER_MAX_T rows, gathers and their
backward scatter-adds are one-hot matrix products. That layout was chosen
for the machine the renderer was first built on; whether it beats a plain
``table[idx]`` gather on the GPU is an open measurement (ROADMAP). The
products run at ``Precision.HIGHEST``: in TF32 a one-hot product would
round every gathered float to a 10-bit mantissa.

CONSTRAINT: gather_rows/gather_fields/unpack use ``jax.custom_vjp``, so the
shading path is reverse-mode only — ``jax.jvp``/``jacfwd`` through it raise.
All framework gradients (fit, grad_render, FD checks) are reverse-mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Tables up to this height gather and scatter through one-hot products
# (the one-hot is [N, T] f32); taller tables use the native gather.
MATMUL_SCATTER_MAX_T = 256


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``table[idx]`` with a one-hot-product backward for small tables.

    Forward is a plain row gather. Backward for T <= MATMUL_SCATTER_MAX_T
    computes the row-cotangent reduction as onehot^T @ cot (f32-exact via
    HIGHEST) instead of a scatter-add.
    """
    T = table.shape[0]
    if T > MATMUL_SCATTER_MAX_T:
        return table[idx]

    @jax.custom_vjp
    def g(tab, i):
        return tab[i]

    def fwd(tab, i):
        return tab[i], i

    def bwd(i, cot):
        oh = (i[:, None] == jnp.arange(T, dtype=i.dtype)[None, :])
        d_tab = jnp.dot(oh.astype(cot.dtype).T, cot,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        return d_tab, None

    g.defvjp(fwd, bwd)
    return g(table, idx)


def _split_fields(rows: jnp.ndarray, fields) -> tuple:
    """Slice a fields-major [W, N] block into per-field arrays: slices come
    back as [N, w], int fields as [N]."""
    return tuple(rows[s].T if isinstance(s, slice) else rows[s]
                 for s in fields)


def gather_fields(table: jnp.ndarray, idx: jnp.ndarray, fields) -> tuple:
    """Fetch per-lane shading attributes: ``split(table[idx], fields)``.

    For small tables the rows are produced transposed as [W, N] by a
    one-hot product

        rows = table^T [W, T] @ onehot(idx) [T, N]

    so each field is a contiguous slice of the block. The backward is the
    mirrored product (cot_rows @ onehot^T). f32-exact: the one-hot selects
    exactly one column and Precision.HIGHEST keeps full f32. Tables taller
    than MATMUL_SCATTER_MAX_T use the native gather + slice path.
    """
    T = table.shape[0]
    if T > MATMUL_SCATTER_MAX_T:
        return unpack(gather_rows(table, idx), fields)

    fields = tuple(fields)

    def onehot(i):
        return (jnp.arange(T, dtype=i.dtype)[:, None]
                == i[None, :]).astype(jnp.float32)

    @jax.custom_vjp
    def g(tab, i):
        rows = jnp.dot(tab.T, onehot(i),
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return _split_fields(rows, fields)

    def fwd(tab, i):
        return g(tab, i), i

    def bwd(i, cots):
        parts = [c if c.ndim == 1 else c.T for c in cots]
        cot_rows = jnp.concatenate(
            [p[None, :] if p.ndim == 1 else p for p in parts], axis=0)
        d_tab_t = jnp.dot(cot_rows, onehot(i).T,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        return d_tab_t.T, None

    g.defvjp(fwd, bwd)
    return g(table, idx)

# ---- tri_pack column layout -------------------------------------------------
NORMAL = slice(0, 3)       # geometric normal (mesh.cpp:78)
N0 = slice(3, 6)           # per-vertex shading normals
N1 = slice(6, 9)
N2 = slice(9, 12)
UV0 = slice(12, 14)
UV1 = slice(14, 16)
UV2 = slice(16, 18)
SMOOTH = 18                # smoothing-group flag, 0.0/1.0
DIFFUSE = slice(19, 22)    # material fields, joined via mat_id
SPECULAR = slice(22, 25)
EMISSIVE = slice(25, 28)
EMISS_INT = 28
ROUGHNESS = 29
REFLECTIVENESS = 30
TRANSLUCENCY = 31
IOR = 32
MAT_TYPE = 33              # 0.0 = OPAQUE, 1.0 = TRANSLUCENT
TEX_IDX = slice(34, 40)    # six texture-slot indices, -1.0 = none
TANGENT = slice(40, 43)
BITANGENT = slice(43, 46)
V0 = slice(46, 49)         # winner-triangle geometry for the straight-through
E1 = slice(49, 52)         # (t, u, v) recompute in shade (hit_vjp="recompute")
E2 = slice(52, 55)
TRI_PACK_WIDTH = 55

# ordered, disjoint, covering — required by unpack()'s concat backward
TRI_FIELDS = (NORMAL, N0, N1, N2, UV0, UV1, UV2, SMOOTH,
              DIFFUSE, SPECULAR, EMISSIVE, EMISS_INT, ROUGHNESS,
              REFLECTIVENESS, TRANSLUCENCY, IOR, MAT_TYPE, TEX_IDX,
              TANGENT, BITANGENT, V0, E1, E2)

# ---- light_pack column layout ------------------------------------------------
L_V0 = slice(0, 3)
L_E1 = slice(3, 6)
L_E2 = slice(6, 9)
L_COLOR = slice(9, 12)     # emissive * emissive_intensity, premultiplied
L_TRI = 12                 # scene triangle index of the light
LIGHT_PACK_WIDTH = 13

LIGHT_FIELDS = (L_V0, L_E1, L_E2, L_COLOR, L_TRI)


def unpack(row: jnp.ndarray, fields) -> tuple:
    """Split a gathered row block into per-field arrays, with a backward
    that is ONE concatenate.

    Autodiff's reverse of k slices is k pad+add passes over the full
    [N, W] cotangent. The fields are disjoint slices covering the row, so
    the exact VJP is a single concatenation of the field cotangents.

    ``fields`` is a list of (slice | int); ints yield [N] arrays.
    """

    @jax.custom_vjp
    def f(r):
        return tuple(r[:, s] for s in fields)

    def fwd(r):
        return f(r), None

    def bwd(_, cots):
        parts = [c[:, None] if c.ndim == 1 else c for c in cots]
        return (jnp.concatenate(parts, axis=1),)

    f.defvjp(fwd, bwd)
    return f(row)


def build_tri_pack(scene) -> jnp.ndarray:
    """f32[T, 55] joined triangle + material shading table."""
    g, m = scene.geom, scene.materials
    # Integer ids ride as f32 columns — exact only below 2^24.
    assert g.v0.shape[0] < 2 ** 24, "tri ids stored as f32 in the pack"
    assert m.tex_index.shape[0] < 2 ** 24, "texture ids stored as f32"
    mid = g.mat_id
    f32 = jnp.float32

    def col(x):
        return x.astype(f32)[:, None]

    return jnp.concatenate([
        g.normal, g.n0, g.n1, g.n2,
        g.uv0, g.uv1, g.uv2,
        col(g.smoothing),
        m.diffuse[mid], m.specular[mid], m.emissive[mid],
        col(m.emissive_intensity[mid]), col(m.roughness[mid]),
        col(m.reflectiveness[mid]), col(m.translucency[mid]),
        col(m.ior[mid]), col(m.mat_type[mid]),
        m.tex_index[mid].astype(f32),
        g.tangent, g.bitangent,
        g.v0, g.e1, g.e2,
    ], axis=1)


def build_light_pack(scene) -> jnp.ndarray:
    """f32[L, 13] light-sampling table (pathtracer.cpp:504-531 inputs)."""
    g, m = scene.geom, scene.materials
    assert g.v0.shape[0] < 2 ** 24, "light tri ids stored as f32 in the pack"
    lt = scene.lights
    lmid = g.mat_id[lt]
    lcolor = m.emissive[lmid] * m.emissive_intensity[lmid][:, None]
    return jnp.concatenate([
        g.v0[lt], g.e1[lt], g.e2[lt], lcolor,
        lt.astype(jnp.float32)[:, None],
    ], axis=1)


def build_uv_opacity_pack(scene) -> jnp.ndarray:
    """f32[T, 7] = (uv0, uv1, uv2, opacity tex index) for the stochastic
    alpha re-trace loop (ops/hit.py)."""
    from ..utils.constants import TEX_OPACITY
    g, m = scene.geom, scene.materials
    otex = m.tex_index[g.mat_id, TEX_OPACITY].astype(jnp.float32)
    return jnp.concatenate([g.uv0, g.uv1, g.uv2, otex[:, None]], axis=1)
