"""Sharded rendering and training steps.

Strategy: explicit SPMD via ``shard_map``. Every per-lane array in the
integrator is elementwise over the pixel dimension and every scene access
is a gather from replicated arrays, so each device renders/differentiates
its local pixel shard independently and the ONLY collectives are explicit:
one end-of-step ``psum`` of (loss, grads) in the training step, none in
forward renders.

Why not GSPMD sharding propagation: compiling the same step under plain
``jit`` + NamedSharding lets XLA place the replicated-table gradient
reductions INSIDE the backward segment scan — measured on the compiled
HLO: a tuple all-reduce of four texture-grad f32[2,512,512,4] buffers,
the tri-pack and light-pack cotangents EVERY segment iteration, plus a
forward dead-skip predicate all-reduce per segment — orders of magnitude
more collective traffic than the one psum the DP-over-rays layout needs.
shard_map pins the program to the intended schedule.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.integrator import render_sample
from ..scene.scene import Camera, Scene
from .mesh import RAYS_AXIS, make_mesh, pad_to_devices, ray_sharding, replicated


_SHARDED_RENDER_CACHE: dict = {}


def _sharded_render_fn(mesh, cfg):
    """Jitted sharded render step, memoized per (mesh, cfg): repeated
    calls reuse one compile — seed and sample_start enter as traced
    arguments."""
    key = (mesh, cfg)
    fn = _SHARDED_RENDER_CACHE.get(key)
    if fn is not None:
        return fn

    def local_render(scene, camera, pixel_idx, seed, sample_start):
        # pixel_idx is this device's shard; zero cross-device traffic.
        acc = jnp.zeros((pixel_idx.shape[0], 3), jnp.float32)

        def body(a, k):
            return a + render_sample(scene, camera, cfg, k,
                                     pixel_idx=pixel_idx, seed=seed), None
        ks = sample_start + jnp.arange(cfg.spp, dtype=jnp.uint32)
        acc, _ = jax.lax.scan(body, acc, ks)
        return acc / jnp.float32(cfg.spp)

    spec = P(tuple(mesh.axis_names))
    fn = jax.jit(jax.shard_map(local_render, mesh=mesh,
                           in_specs=(P(), P(), spec, P(), P()),
                           out_specs=spec, check_vma=False))
    _SHARDED_RENDER_CACHE[key] = fn
    return fn


def render_sharded(scene: Scene, camera: Camera, cfg, mesh=None, seed=None,
                   sample_start: int = 0):
    """Forward render with the pixel wavefront sharded over the mesh.

    Returns f32[H, W, 3] mean radiance (fully addressable on host).
    ``sample_start`` offsets the absolute sample counter so callers can
    split a high-spp render into several calls and average the results —
    the keyed RNG makes split accumulation bit-identical to one pass
    (engine/session.py semantics).
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    n_pix = cfg.width * cfg.height
    n_pad = pad_to_devices(n_pix, n_dev)

    order = cfg.pixel_order
    if order == "block":
        # compact-tile lane layout (ops/integrator.block_pixel_order);
        # undone by the scatter below
        from ..ops.integrator import block_pixel_order
        base = jnp.asarray(block_pixel_order(cfg.width, cfg.height))
    else:
        base = jnp.arange(n_pix, dtype=jnp.int32)
    # Padding lanes re-trace pixel 0; their results are dropped on reshape.
    pixel_idx = jnp.concatenate(
        [base, jnp.zeros((n_pad - n_pix,), jnp.int32)])
    pixel_idx = jax.device_put(pixel_idx, ray_sharding(mesh))

    seed = (jnp.uint32(cfg.seed) if seed is None
            else jnp.asarray(seed, jnp.uint32))
    go = _sharded_render_fn(mesh, cfg)
    img = jax.device_put(go(scene, camera, pixel_idx, seed,
                            jnp.uint32(sample_start)),
                         NamedSharding(mesh, P()))
    img = jnp.asarray(img)[:n_pix]
    if order == "block":
        img = jnp.zeros_like(img).at[base].set(img)
    return img.reshape(cfg.height, cfg.width, 3)


def make_train_step_overlapped(scene_template: Scene, camera_template: Camera,
                               cfg, optimizer, mesh):
    """Sharded inverse-rendering step with the gradient psum OVERLAPPED
    with the backward sweep (the north-star prescription; spp ≥ 2).

    The fused step (make_train_step) reduces the whole grad pytree in ONE
    psum that can only start after the entire backward finishes — nothing
    hides its latency. This variant restructures the multi-sample loss so
    communication pipelines with compute:

      * pass 1: forward-only scan over the spp samples → mean image and
        the shared loss cotangent c = 2(img − target)/(N_pix · spp)
        (the L2 pixel loss is pixelwise, so c needs no cross-device data);
      * pass 2: per-sample VJP scan carrying the UNREDUCED previous
        sample's gradient — each body psums sample k−1's grads while
        computing sample k's forward+backward, which have no data
        dependence on that psum. XLA's async collectives (all-reduce
        start/done pairs) can therefore run sample k's entire fwd+bwd
        under the all-reduce of sample k−1.

    Cost: one extra forward pass (pass 2's VJP re-runs each sample's
    forward instead of stashing spp× residuals). Worth it exactly when
    psum latency is a visible fraction of the step — cross-host fits,
    MB-scale texture grads. Gradients equal make_train_step's up to
    float summation order (per-sample partials accumulate forward here,
    reverse-of-scan there); tests/test_parallel.py pins allclose.
    """
    from ..diff.params import clip_params, set_params

    assert cfg.spp >= 2, "overlap needs ≥2 samples (one psum in flight)"
    n_dev = mesh.devices.size
    n_pix = cfg.width * cfg.height
    assert n_pix % n_dev == 0, "pixel count must divide device count"
    axes = tuple(mesh.axis_names)

    def sample_flat(params, scene, camera, pixel_idx, k, seed):
        scene, camera = set_params(scene, camera, params)
        return render_sample(scene, camera, cfg, k, pixel_idx=pixel_idx,
                             seed=seed)

    def local_step(params, opt_state, scene, camera, pixel_idx, target_flat,
                   seed):
        # ---- pass 1: forward-only mean image + cotangent ----
        def fwd_body(a, k):
            return a + sample_flat(params, scene, camera, pixel_idx, k,
                                   seed), None
        acc, _ = jax.lax.scan(fwd_body, jnp.zeros_like(target_flat),
                              jnp.arange(cfg.spp, dtype=jnp.uint32))
        img = acc / jnp.float32(cfg.spp)
        diff = img - target_flat
        cot = diff * (2.0 / (n_pix * 3 * cfg.spp))
        loss = jax.lax.psum(jnp.sum(diff * diff), axes) / (n_pix * 3)

        # ---- pass 2: per-sample VJP with the psum one sample behind ----
        # Sample 0's VJP runs before the scan so the pipeline carries a
        # REAL pending gradient from iteration one — no wasted full-size
        # psum of an all-zero pytree (and exactly one psum per sample).
        zero_g = jax.tree_util.tree_map(jnp.zeros_like, params)
        _, vjp0 = jax.vjp(lambda p: sample_flat(p, scene, camera,
                                                pixel_idx,
                                                jnp.uint32(0), seed),
                          params)
        (g0,) = vjp0(cot)

        def bwd_body(carry, k):
            gacc, gpend = carry
            # psum of the PREVIOUS sample's partial grads: no data
            # dependence on this sample's VJP below → overlappable.
            gred = jax.tree_util.tree_map(
                lambda g: jax.lax.psum(g, axes), gpend)
            _, vjp = jax.vjp(lambda p: sample_flat(p, scene, camera,
                                                   pixel_idx, k, seed),
                             params)
            (gs,) = vjp(cot)
            gacc = jax.tree_util.tree_map(jnp.add, gacc, gred)
            return (gacc, gs), None

        (gacc, gpend), _ = jax.lax.scan(
            bwd_body, (zero_g, g0),
            jnp.arange(1, cfg.spp, dtype=jnp.uint32))
        grads = jax.tree_util.tree_map(
            lambda a, g: a + jax.lax.psum(g, axes), gacc, gpend)

        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        params = clip_params(params)
        return params, opt_state, loss

    P_ray = P(axes)
    rep_spec = P()
    step = jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(rep_spec, rep_spec, rep_spec, rep_spec, P_ray, P_ray,
                  rep_spec),
        out_specs=(rep_spec, rep_spec, rep_spec),
        check_vma=False))
    return step


def make_train_step(scene_template: Scene, camera_template: Camera, cfg,
                    optimizer, mesh):
    """Build a jitted sharded inverse-rendering step.

    Per-device: render the local pixel shard, local-mean loss vs the target
    shard; the global mean and parameter grads reduce over the rays axis via
    GSPMD-inserted collectives. Params/optimizer state stay replicated.
    (See make_train_step_overlapped for the psum/backward-overlap variant.)
    """
    from ..diff.params import clip_params, set_params

    n_dev = mesh.devices.size
    n_pix = cfg.width * cfg.height
    assert n_pix % n_dev == 0, "pixel count must divide device count"
    axes = tuple(mesh.axis_names)

    def loss_local(params, scene, camera, pixel_idx, target_flat, seed):
        # Local-shard contribution to the GLOBAL mean: sum of squared error
        # over this device's pixels, pre-divided by the global element
        # count. psum of this (and of its grads) is the global mean loss
        # (and its grads) — one collective round, at the end of backward.
        scene, camera = set_params(scene, camera, params)
        acc = jnp.zeros_like(target_flat)

        def body(a, k):
            return a + render_sample(scene, camera, cfg, k,
                                     pixel_idx=pixel_idx, seed=seed), None
        acc, _ = jax.lax.scan(body, acc, jnp.arange(cfg.spp, dtype=jnp.uint32))
        img = acc / jnp.float32(cfg.spp)
        return jnp.sum((img - target_flat) ** 2) / (n_pix * 3)

    def local_step(params, opt_state, scene, camera, pixel_idx, target_flat,
                   seed):
        sq, grads = jax.value_and_grad(loss_local)(
            params, scene, camera, pixel_idx, target_flat, seed)
        loss = jax.lax.psum(sq, axes)
        grads = jax.tree_util.tree_map(lambda g: jax.lax.psum(g, axes),
                                       grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        params = clip_params(params)
        return params, opt_state, loss

    pix_spec = P(axes)
    rep_spec = P()
    train_step = jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(rep_spec, rep_spec, rep_spec, rep_spec, pix_spec,
                  pix_spec, rep_spec),
        out_specs=(rep_spec, rep_spec, rep_spec),
        check_vma=False))
    return train_step
