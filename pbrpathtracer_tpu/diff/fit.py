"""Inverse-rendering optimization loop (BASELINE config 5's "fit of
materials+lights"): optax on the differentiable parameter pytree.

Checkpoint/resume (SURVEY.md §5 checkpoint row): the optimizer state, the
parameter pytree, the absolute step counter and the loss history serialize
together, and resume is *trajectory-exact* — per-step RNG is keyed by the
absolute step index (cfg.seed + step), so an interrupted fit continues on
bit-identical gradients (tests/test_diff.py::test_fit_checkpoint_resume)."""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax

from .loss import l2_image_loss
from .params import clip_params, get_params, set_params


@dataclasses.dataclass
class FitResult:
    params: dict
    losses: list
    scene: object
    camera: object


def save_fit_checkpoint(path: str, params, opt_state, step: int, losses):
    """Serialize (params, optimizer state, absolute step, loss history).

    Pytrees are stored as flattened leaf lists; the treedefs are structural
    and rebuilt from templates on load (same opt/params spec required)."""
    p_leaves = jax.tree_util.tree_leaves(params)
    o_leaves = jax.tree_util.tree_leaves(opt_state)
    payload = {f"p{i}": np.asarray(x) for i, x in enumerate(p_leaves)}
    payload.update({f"o{i}": np.asarray(x) for i, x in enumerate(o_leaves)})
    np.savez(path, step=step, losses=np.asarray(losses, np.float64),
             n_p=len(p_leaves), n_o=len(o_leaves), **payload)


def load_fit_checkpoint(path: str, params_template, opt_state_template):
    """Restore (params, opt_state, step, losses) from save_fit_checkpoint.

    Templates (a fresh get_params / opt.init result) supply the pytree
    structure; the checkpoint supplies the leaves."""
    data = np.load(path)
    n_p, n_o = int(data["n_p"]), int(data["n_o"])
    p_def = jax.tree_util.tree_structure(params_template)
    o_def = jax.tree_util.tree_structure(opt_state_template)
    p_leaves = [jnp.asarray(data[f"p{i}"]) for i in range(n_p)]
    o_leaves = [jnp.asarray(data[f"o{i}"]) for i in range(n_o)]
    assert p_def.num_leaves == n_p and o_def.num_leaves == n_o, \
        "checkpoint does not match the params/optimizer spec"
    return (jax.tree_util.tree_unflatten(p_def, p_leaves),
            jax.tree_util.tree_unflatten(o_def, o_leaves),
            int(data["step"]), [float(x) for x in data["losses"]])


def fit(scene, camera, cfg, target, *, steps=100, lr=2e-2,
        materials=True, textures=False, camera_lens=False,
        sample_offset_per_step=True, optimizer=None, callback=None,
        checkpoint_path=None, checkpoint_every=0, resume=False):
    """Fit selected scene/camera parameters to a target image.

    ``sample_offset_per_step`` re-seeds each step (different MC sample set)
    so the optimizer sees fresh noise — standard stochastic inverse
    rendering practice.

    ``checkpoint_path`` + ``checkpoint_every=k`` write a full optimizer
    checkpoint every k steps; ``resume=True`` restores it (if present) and
    continues from the saved absolute step, trajectory-exact.
    """
    params = get_params(scene, camera, materials=materials,
                        textures=textures, camera_lens=camera_lens)
    opt = optimizer if optimizer is not None else optax.adam(lr)
    opt_state = opt.init(params)
    start_step = 0
    losses: list = []
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        params, opt_state, start_step, losses = load_fit_checkpoint(
            checkpoint_path, params, opt_state)
    target = jnp.asarray(target)

    # scene and camera are arguments, not constants folded into the
    # compiled step: folding computes scene-derived floats on the host, a
    # few ULPs away from what the device computes in ``render``
    @jax.jit
    def step(params, opt_state, scene, camera, target, seed):
        loss, grads = jax.value_and_grad(l2_image_loss)(
            params, scene, camera, cfg, target, seed)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = clip_params(params)
        return params, opt_state, loss

    for s in range(start_step, steps):
        seed = jnp.uint32(cfg.seed + (s if sample_offset_per_step else 0))
        params, opt_state, loss = step(params, opt_state, scene, camera,
                                       target, seed)
        losses.append(float(loss))
        if callback is not None:
            callback(s, losses[-1], params)
        if (checkpoint_path and checkpoint_every
                and (s + 1) % checkpoint_every == 0):
            save_fit_checkpoint(checkpoint_path, params, opt_state, s + 1,
                                losses)

    final_scene, final_camera = set_params(scene, camera, params)
    return FitResult(params=params, losses=losses, scene=final_scene,
                     camera=final_camera)
