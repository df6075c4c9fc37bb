"""BVH construction (host side) → flattened stackless layout.

The reference builds a pointer-based binary BVH with a *random* split axis
per node (fresh std::random_device, mesh.cpp:169-178), size-1 leaves that
duplicate the triangle into both children (mesh.cpp:182-186), and recursive
two-children-always traversal (pathtracer.cpp:411-462). Redesign for a
vectorized walk (SURVEY.md §7 step 2, deviations documented):

* deterministic split: median on the axis of largest centroid extent
  (traversal-order-only change — closest-hit results are identical);
* multi-triangle leaves (default 8) — wide leaves amortize the gather cost
  of per-lane traversal and map to vector ops;
* flattened depth-first with *escape links*: node i's subtree occupies
  [i, escape_i); on bbox hit the cursor advances to i+1, on miss to
  escape_i — no stack, a single monotone cursor, bounded trip count:
  traversal is a `lax.while_loop` with per-lane cursors.

Layout (FlatBVH):
  bounds_min/max f32[M,3]
  first  i32[M]  — leaf: first triangle slot in the permuted order; else 0
  count  i32[M]  — leaf: triangle count; interior: 0
  escape i32[M]  — index of the first node NOT in this subtree
  perm   i32[Tp] — permuted triangle ids (padded with -1 to leaf multiple)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class FlatBVH:
    bounds_min: jnp.ndarray   # f32[M,3]
    bounds_max: jnp.ndarray   # f32[M,3]
    first: jnp.ndarray        # i32[M]
    count: jnp.ndarray        # i32[M]
    escape: jnp.ndarray       # i32[M]
    perm: jnp.ndarray         # i32[T]
    leaf_size: int = static_field(8)

    @property
    def num_nodes(self) -> int:
        return self.first.shape[0]


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_size: int = 8) -> FlatBVH:
    """Median-split BVH over triangles; returns the flattened layout."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    # iterative build with an explicit stack; nodes appended in DFS order
    bounds_min, bounds_max, first, count, escape = [], [], [], [], []
    perm_out = []

    def new_node(bmin, bmax):
        bounds_min.append(bmin)
        bounds_max.append(bmax)
        first.append(0)
        count.append(0)
        escape.append(0)
        return len(first) - 1

    def build(ids):
        bmin = tri_min[ids].min(axis=0)
        bmax = tri_max[ids].max(axis=0)
        # degenerate-extent epsilon (AABB::Check parity, mesh.cpp:32-46)
        bmax = np.where(bmax - bmin < 1e-5, bmin + 1e-5, bmax)
        node = new_node(bmin, bmax)
        if len(ids) <= leaf_size:
            first[node] = len(perm_out)
            count[node] = len(ids)
            perm_out.extend(ids.tolist())
        else:
            c = centroid[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order = np.argsort(c[:, axis], kind="stable")
            half = len(ids) // 2
            build(ids[order[:half]])
            build(ids[order[half:]])
        escape[node] = len(first)
        return node

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(np.arange(T))
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        bounds_min=jnp.asarray(np.asarray(bounds_min, np.float32)),
        bounds_max=jnp.asarray(np.asarray(bounds_max, np.float32)),
        first=jnp.asarray(np.asarray(first, np.int32)),
        count=jnp.asarray(np.asarray(count, np.int32)),
        escape=jnp.asarray(np.asarray(escape, np.int32)),
        perm=jnp.asarray(np.asarray(perm_out, np.int32)),
        leaf_size=leaf_size,
    )


def validate_bvh(bvh: FlatBVH, n_tris: int) -> None:
    """Structural invariants (used by tests and the C++-builder cross-check).

    Raises AssertionError on violation."""
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    escape = np.asarray(bvh.escape)
    bmin = np.asarray(bvh.bounds_min)
    bmax = np.asarray(bvh.bounds_max)
    perm = np.asarray(bvh.perm)
    M = len(first)

    assert (bmax >= bmin).all(), "inverted bounds"
    assert sorted(perm.tolist()) == list(range(n_tris)), "perm not a permutation"
    # escape monotonicity + subtree containment
    for i in range(M):
        assert i < escape[i] <= M, f"bad escape at {i}"
        if count[i] == 0:          # interior: has at least 2 nodes inside
            assert escape[i] > i + 1, f"empty interior {i}"
        else:
            assert escape[i] == i + 1, f"leaf {i} escape must be i+1"
    # every leaf range valid
    leaves = np.nonzero(count > 0)[0]
    covered = 0
    for i in leaves:
        assert first[i] + count[i] <= len(perm)
        covered += count[i]
    assert covered == n_tris
