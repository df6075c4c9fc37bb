"""Multi-host distribution layer (SURVEY.md §2.2 / §5 distributed rows).

The reference's only concurrency is two OpenMP threads sharing bools and a
pixel buffer inside one process (main.cpp:3666-3677). This layer scales the
ray wavefront across processes and their cards:

  * one JAX process per host (or per card), joined via
    ``jax.distributed.initialize``;
  * a ("host", "device") mesh — device order sorted by (process_index,
    device id) so each process owns a contiguous block of the mesh;
  * the (pixel × sample) wavefront sharded over BOTH axes (the pixel
    dimension splits host-major, so every process renders a contiguous
    image stripe and its cards sub-stripes of it);
  * the scene (triangles, BVH, materials, textures) replicated per device;
  * parameter gradients psum'd over the whole mesh;
  * the final image assembled on host 0 with one cross-process gather.

Rays are embarrassingly parallel, so forward renders need ZERO cross-host
communication until the final gather; inverse rendering adds exactly one
all-reduce (the grad psum) per step. Tested by running two CPU processes
over localhost (tests/test_multihost.py).

Several processes on one machine must each open only their own card: a
JAX process reserves most of every card it opens. Pass
``local_device_ids`` to ``initialize`` (or start each process with its own
``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HOST_AXIS = "host"
DEVICE_AXIS = "device"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None,
               **kw) -> tuple[int, int]:
    """Join the multi-host job; returns (process_index, process_count).

    Arguments fall back to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Nothing auto-detects a cluster on
    a plain GPU machine, so give all three. ``local_device_ids`` limits
    this process to those cards of its machine (e.g. ``[process_id]`` for
    one process per card). Call once per process, before any other JAX
    API touches the backend.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids, **kw)
    return jax.process_index(), jax.process_count()


def host_device_mesh(devices=None) -> Mesh:
    """("host", "device") mesh over all global devices.

    Rows = processes (hosts), columns = each process's local cards.
    Device order inside the mesh is (process_index, device id), so the
    host axis boundary coincides with the process boundary.
    """
    if devices is None:
        devices = jax.devices()
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    n_proc = len({d.process_index for d in devices})
    per_host = len(devices) // n_proc
    assert n_proc * per_host == len(devices), \
        "uneven devices per host is unsupported"
    arr = np.array(devices).reshape(n_proc, per_host)
    return Mesh(arr, (HOST_AXIS, DEVICE_AXIS))


def wavefront_sharding(mesh: Mesh) -> NamedSharding:
    """Pixel/ray dimension sharded host-major over both mesh axes."""
    return NamedSharding(mesh, P((HOST_AXIS, DEVICE_AXIS)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def render_multihost(scene, camera, cfg, mesh: Mesh | None = None,
                     seed=None, gather: bool = True):
    """Forward render with the wavefront sharded across hosts and cards.

    Every host computes only its local pixel stripe. With ``gather=True``
    (default) the full f32[H, W, 3] image is assembled on every host via
    one cross-process allgather (host 0 uses it; others may drop it);
    with ``gather=False`` the per-host jax.Array (globally sharded, only
    local shards addressable) is returned for callers that keep working
    in sharded form.
    """
    from ..ops.integrator import render_sample
    from ..parallel.mesh import pad_to_devices

    if mesh is None:
        mesh = host_device_mesh()
    n_dev = mesh.devices.size
    n_pix = cfg.width * cfg.height
    n_pad = pad_to_devices(n_pix, n_dev)
    shard = wavefront_sharding(mesh)

    # Global pixel-index array: each device materializes only its shard.
    @partial(jax.jit, out_shardings=shard)
    def make_pixels():
        idx = jnp.arange(n_pad, dtype=jnp.int32)
        return jnp.where(idx < n_pix, idx, 0)

    pixel_idx = make_pixels()

    @partial(jax.jit,
             in_shardings=(replicated(mesh), replicated(mesh), shard),
             out_shardings=shard)
    def go(scene, camera, pixel_idx):
        acc = jnp.zeros((n_pad, 3), jnp.float32)

        def body(a, k):
            return a + render_sample(scene, camera, cfg, k,
                                     pixel_idx=pixel_idx, seed=seed), None
        acc, _ = jax.lax.scan(body, acc, jnp.arange(cfg.spp, dtype=jnp.uint32))
        return acc / jnp.float32(cfg.spp)

    scene_r = jax.device_put(scene, replicated(mesh))
    camera_r = jax.device_put(camera, replicated(mesh))
    acc = go(scene_r, camera_r, pixel_idx)
    if not gather:
        return acc
    from jax.experimental import multihost_utils
    img = np.asarray(multihost_utils.process_allgather(acc, tiled=True))
    return img[:n_pix].reshape(cfg.height, cfg.width, 3)


def make_train_step_multihost(scene, camera, cfg, optimizer,
                              mesh: Mesh | None = None):
    """Sharded inverse-rendering step over the ("host","device") mesh.

    Same contract as parallel.render.make_train_step: params/optimizer
    state replicated, pixels + target sharded; grads all-reduce over both
    mesh axes.
    """
    from ..parallel.render import make_train_step
    if mesh is None:
        mesh = host_device_mesh()
    return make_train_step(scene, camera, cfg, optimizer, mesh)


def local_pixel_slice(cfg, mesh: Mesh | None = None) -> slice:
    """The contiguous global pixel range owned by this process."""
    if mesh is None:
        mesh = host_device_mesh()
    from ..parallel.mesh import pad_to_devices
    n_pix = cfg.width * cfg.height
    n_pad = pad_to_devices(n_pix, mesh.devices.size)
    per_host = n_pad // jax.process_count()
    lo = jax.process_index() * per_host
    return slice(lo, min(lo + per_host, n_pix))
