#!/usr/bin/env python
"""Golden-image regression net.

Renders the five BASELINE ladder scenes at small size and compares
against committed goldens (tests/goldens/*.npz) so cross-round image
drift — e.g. from intersection-kernel rewrites — is caught
automatically.

Modes:
  record — render on the current backend and (over)write the goldens;
  check  — render and compare: per-pixel agreement within a tolerance
           derived from each golden's recorded per-pixel MC variance.

The RNG is keyed by (pixel, sample, bounce) so any backend renders the
same estimator draws; remaining differences are float-accumulation
order across backends/kernel versions, which stay ULP-small unless a
*decision* (hit choice, RR gate) flips — those show up as isolated
outlier pixels, so the check bounds BOTH the mean drift and the
fraction of outlier pixels.

The committed goldens were recorded by an earlier build of the renderer;
tests/test_goldens.py checks the CPU render and chip_smoke.py phase 3 the
GPU render against them, with the same bounds.
"""

import argparse
import json
import os
import sys
import warnings

warnings.filterwarnings("ignore")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")

# name -> (scene builder, camera builder, cfg kwargs)
def _configs():
    from pbrpathtracer_tpu.scene import builders
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera)
    from pbrpathtracer_tpu.scene.scene import Camera

    cam = lambda **kw: Camera.make(pos=(0.013, 0.021, 0.217),
                                   dir=(0.02, -0.03, 1), up=(0, 1, 0),
                                   fovy=61, **kw)
    return {
        "rung1_cornell": (
            lambda: builders.cornell_box(), cam,
            dict(width=128, height=128, max_depth=3, spp=16)),
        "rung2_spheres": (
            lambda: builders.cornell_spheres_scene(), cam,
            dict(width=128, height=128, max_depth=3, spp=16)),
        "rung3_mesh50k": (
            lambda: mesh_scene(50_000, accel="always"), mesh_scene_camera,
            dict(width=128, height=128, max_depth=3, spp=16)),
        "rung4_translucent": (
            lambda: builders.translucent_scene(),
            lambda: cam(focal_dist=2.2, aperture=0.04),
            dict(width=128, height=128, max_depth=4, spp=16)),
        "rung5_million": (
            lambda: mesh_scene(200_000, accel="always"), mesh_scene_camera,
            dict(width=128, height=128, max_depth=3, spp=8)),
    }


def render_one(name, spec):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.ops.integrator import render_sample

    build_scene, build_cam, kw = spec
    scene = build_scene()
    camera = build_cam()
    cfg = RenderConfig(**kw)

    # mean image + per-pixel sample variance (for the tolerance model)
    @jax.jit
    def run():
        def body(carry, k):
            s, s2 = carry
            img = render_sample(scene, camera, cfg, k)
            return (s + img, s2 + img * img), None
        z = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
        (s, s2), _ = jax.lax.scan(body, (z, z),
                                  jnp.arange(cfg.spp, dtype=jnp.uint32))
        mean = s / cfg.spp
        var = jnp.maximum(s2 / cfg.spp - mean * mean, 0.0)
        return mean, var

    mean, var = run()
    return (np.asarray(mean).reshape(cfg.height, cfg.width, 3),
            np.asarray(var).reshape(cfg.height, cfg.width, 3), cfg)


def compare(mean, var, g):
    """Bound mean drift and outlier-pixel fraction vs a golden record."""
    import numpy as np
    gm, gv = g["mean"], g["var"]
    spp = int(g["spp"])
    # per-pixel MC std of the golden's mean estimate
    sigma = np.sqrt((gv + var) / spp) + 1e-4
    diff = np.abs(mean - gm)
    outlier_frac = float((diff > 6.0 * sigma).mean())
    return {
        "mean_drift": float(np.abs(mean.mean() - gm.mean())),
        "rmse": float(np.sqrt(((mean - gm) ** 2).mean())),
        "outlier_frac": outlier_frac,
        "ok": bool(np.abs(mean.mean() - gm.mean()) < 2e-3
                   and outlier_frac < 2e-3),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["record", "check"])
    ap.add_argument("--names", default="")
    args = ap.parse_args()

    import numpy as np
    from pbrpathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    configs = _configs()
    names = args.names.split(",") if args.names else list(configs)
    results = {}
    for name in names:
        mean, var, cfg = render_one(name, configs[name])
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        if args.mode == "record":
            np.savez_compressed(path, mean=mean, var=var, spp=cfg.spp)
            results[name] = {"recorded": True, "mean": float(mean.mean()),
                             "shape": list(mean.shape)}
        else:
            g = np.load(path)
            results[name] = compare(mean, var, g)
        print(json.dumps({name: results[name]}), flush=True)
    if args.mode == "check":
        ok = all(r["ok"] for r in results.values())
        print(json.dumps({"all_ok": ok}))
        sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
