"""Device-mesh helpers.

Parallelism model (SURVEY.md §2.2): the reference's only data parallelism is
OpenMP rows over pixels (pathtracer.cpp:768-776). Here the (pixel × sample)
ray wavefront is sharded over a 1-D ``rays`` mesh axis — across cards and
hosts — while the scene (triangles, BVH, materials, textures) is
replicated per device and parameter gradients are all-reduced (`psum`)
over the same axis. Rays are embarrassingly parallel, so this needs no
ring/all-to-all; the only collectives are the gradient psum and the final
host-0 image gather. Every card reaches every other at the same rate over
NVLink, so the mesh is a flat list of devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAYS_AXIS = "rays"


def make_mesh(devices=None, axis_name: str = RAYS_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (pixel/ray) dimension across EVERY mesh axis.

    For the 1-D ``rays`` mesh this is P("rays"); for the multi-host
    ("host", "device") mesh (dist/multihost.py) the pixel dimension is
    sharded over both axes so each host computes a contiguous stripe and
    each of its cards a sub-stripe — shard boundaries align with hosts,
    keeping the image assembly a pure gather with no reshuffle."""
    return NamedSharding(mesh, P(tuple(mesh.axis_names)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_devices(n: int, n_dev: int) -> int:
    """Smallest multiple of n_dev ≥ n (pixel counts must divide evenly)."""
    return ((n + n_dev - 1) // n_dev) * n_dev
