#!/usr/bin/env python
"""Smoke test of the renderer on one GPU, through its public entry points.

    python chip_smoke.py           # eight phases on one card
    python chip_smoke.py --four    # the four-card path only

Phases on one card, in order; any failure ends the run with a non-zero
exit code:

  1. device    JAX must see a GPU; prints its kind, the device count and
               nvidia-smi's name and power limit.
  2. render    api.render of the Cornell box at 1024x768, depth 3, 4 spp
               (finite); the same scene at 16x16, 2 spp against the CPU
               oracle with the oracle-parity test's tolerance.
  3. goldens   all five golden scenes (benchmarks/goldens.py bounds).
  4. large     render of the 50k- and 1M-triangle mesh scenes at 512²,
               depth 3, 1 spp: wall time, scene bytes, peak memory.
  5. session   three RenderSession passes; stop, checkpoint and resume,
               and one run with the summed spp, are bit-identical to
               one uninterrupted session.
  6. fit       three fit() steps on the Cornell materials at 256².
  7. kernels   the compiled Pallas closest-hit kernel against the plain
               reference at real widths, then the tests marked ``gpu``.
  8. cli       cli.main("render ...") in this process; the PNG it writes
               decodes to the in-memory render.

``--four`` runs the sharded render, the sharded train steps and the
gradient psum on four cards against their one-card references.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def say(phase, **rec):
    print(json.dumps({"phase": phase, **rec}), flush=True)


def peak_bytes():
    import jax
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def tree_bytes(tree):
    import jax
    return int(sum(x.nbytes for x in jax.tree_util.tree_leaves(tree)))


def timed(fn, *args):
    """(result, seconds) of fn(*args) to completion."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def cornell_camera(**kw):
    from pbrpathtracer_tpu.scene.scene import Camera
    return Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                       up=(0, 1, 0), fovy=61, **kw)


def phase_device(count):
    """Phase 1: a GPU, or fail before anything else runs."""
    from pbrpathtracer_tpu.utils.device import nvidia_smi_line, require_gpu
    device = require_gpu()
    if device["count"] < count:
        raise RuntimeError(f"need {count} GPUs, have {device['count']}")
    smi = nvidia_smi_line()
    say("device", **device, nvidia_smi=smi)
    print(smi, flush=True)
    return device


def phase_render():
    """Phase 2: reference-default render + CPU-oracle parity."""
    import numpy as np
    from pbrpathtracer_tpu import api
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.oracle.cpu_oracle import Oracle
    from pbrpathtracer_tpu.scene.builders import cornell_box

    scene, cam = cornell_box(), cornell_camera()
    cfg = RenderConfig(width=1024, height=768, max_depth=3, spp=4)
    img, first = timed(api.render, scene, cam, cfg)
    img, warm = timed(api.render, scene, cam, cfg)
    img = np.asarray(img)
    assert img.shape == (cfg.height, cfg.width, 3) and np.isfinite(img).all()
    assert img.max() > 0.5, "light not visible"

    small = RenderConfig(width=16, height=16, max_depth=3, spp=2)
    got = np.asarray(api.render(scene, cam, small))
    ref = Oracle(scene, cam, small).render()
    d = np.abs(got - ref).max(axis=-1)
    outliers = float((d > 1e-3).mean())
    inlier_mean = float(d[d <= 1e-3].mean())
    assert outliers <= 0.005 and inlier_mean < 1e-4, (outliers, inlier_mean)
    say("render", config="cornell 1024x768 depth3 spp4", first_call_s=first,
        warm_s=warm, paths_per_s=1024 * 768 * 4 / warm,
        oracle_outlier_frac=outliers, oracle_inlier_mean_abs=inlier_mean,
        peak_bytes_in_use=peak_bytes())


def phase_goldens():
    """Phase 3: all five goldens within benchmarks/goldens.py bounds."""
    import numpy as np
    from benchmarks import goldens as G
    configs = G._configs()
    results = {}
    for name, spec in configs.items():
        t0 = time.perf_counter()
        mean, var, _ = G.render_one(name, spec)
        rep = G.compare(mean, var,
                        np.load(os.path.join(G.GOLDEN_DIR, f"{name}.npz")))
        rep["seconds"] = time.perf_counter() - t0
        results[name] = rep
    say("goldens", results=results)
    bad = [n for n, r in results.items() if not r["ok"]]
    assert not bad, f"goldens out of bounds: {bad}"


def phase_large():
    """Phase 4: 50k and 1M triangles at 512², depth 3, 1 spp."""
    import numpy as np
    from pbrpathtracer_tpu import api
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.ops.hit import _resolve_intersector_name
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera)
    cam = mesh_scene_camera()
    cfg = RenderConfig(width=512, height=512, max_depth=3, spp=1)
    for n in (50_000, 1_000_000):
        t0 = time.perf_counter()
        scene = mesh_scene(n, accel="always")
        build_s = time.perf_counter() - t0
        img, first = timed(api.render, scene, cam, cfg)
        img, warm = timed(api.render, scene, cam, cfg)
        img = np.asarray(img)
        assert np.isfinite(img).all() and img.max() > 0.05
        say("large", triangles=int(scene.num_triangles),
            intersector=_resolve_intersector_name(scene, cfg),
            build_s=build_s, first_call_s=first, warm_s=warm,
            paths_per_s=512 * 512 / warm, scene_bytes=tree_bytes(scene),
            peak_bytes_in_use=peak_bytes())
        del scene, img


def phase_session():
    """Phase 5: progressive passes; stop + checkpoint + resume, and one
    run with the summed spp, are bit-identical to one session."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pbrpathtracer_tpu import api
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.engine.session import RenderSession
    from pbrpathtracer_tpu.ops.integrator import render_accumulate
    from pbrpathtracer_tpu.scene.builders import cornell_box

    scene, cam = cornell_box(), cornell_camera()
    cfg = RenderConfig(width=1024, height=768, max_depth=3, spp=1)
    whole = RenderSession(cfg=cfg, scene=scene, camera=cam)
    whole.start()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        whole.step(1)
        whole.accum.block_until_ready()
        times.append(time.perf_counter() - t0)
    ref = np.asarray(whole.accum)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "session.npz")
        a = RenderSession(cfg=cfg, scene=scene, camera=cam)
        a.start()
        a.step(2)
        a.save_checkpoint(ckpt)
        a.stop()
        b = RenderSession(cfg=cfg, scene=scene, camera=cam)
        b.load_checkpoint(ckpt)
        b.step(1)
        resumed = np.asarray(b.accum)
    assert b.samples == whole.samples == 3
    assert np.isfinite(ref).all()

    # one run with the summed spp: the sum api.render takes before it
    # divides by spp
    batch = np.asarray(jax.jit(lambda sc, ca: render_accumulate(
        sc, ca, cfg, jnp.zeros_like(ref), 0, 3))(scene, cam))
    d = np.abs(batch - ref).max(axis=-1)
    # api.render's mean: XLA turns the division by the constant spp into a
    # multiply by its reciprocal, so it may differ from the session's
    # exact division in the last bit, and in nothing else
    img = np.asarray(api.render(scene, cam, cfg.replace(spp=3)))
    mean = whole.image()
    ulps = np.abs(mean - img) / np.spacing(np.maximum(np.abs(mean),
                                                      np.abs(img)))
    say("session", config="cornell 1024x768 depth3", pass_s=times,
        resumed_bit_identical=bool(np.array_equal(resumed, ref)),
        batch_bit_identical=bool(np.array_equal(batch, ref)),
        batch_px_differ=int((d > 0).sum()), batch_max_abs_diff=float(d.max()),
        mean_vs_render_max_ulps=float(ulps.max()),
        mean_vs_render_px_differ=int((ulps.max(axis=-1) > 0).sum()))
    assert np.array_equal(resumed, ref), float(np.abs(resumed - ref).max())
    assert np.array_equal(batch, ref), (int((d > 0).sum()), float(d.max()))
    assert ulps.max() <= 2, float(ulps.max())


def phase_fit():
    """Phase 6: three fit() steps on the Cornell materials at 256²."""
    import numpy as np
    from pbrpathtracer_tpu import api
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.scene.builders import cornell_box

    scene, cam = cornell_box(), cornell_camera()
    cfg = RenderConfig(width=256, height=256, max_depth=3, spp=1)
    target = np.asarray(api.render(scene, cam, cfg)) * 0.8
    stamps = [time.perf_counter()]
    res = api.fit(scene, cam, cfg, target, steps=3, lr=2e-2,
                  callback=lambda s, l, p: stamps.append(time.perf_counter()))
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    assert np.isfinite(res.losses).all(), res.losses
    for k, v in res.params.items():
        assert np.isfinite(np.asarray(v)).all(), k
    say("fit", config="cornell 256x256 depth3 spp1 materials",
        losses=res.losses, step_s=steps, peak_bytes_in_use=peak_bytes())


class _Counter:
    """pytest plugin: count outcomes of the test calls."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome == "skipped":
            if report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1


def phase_kernels():
    """Phase 7: compiled kernel vs plain reference; gpu-marked tests."""
    import pytest
    from benchmarks import kernel_bench as KB
    recs = KB.check_kernel(KB.query_sets())
    say("kernels", checks=recs)
    bad = [r["case"] for r in recs if not r["ok"]]
    assert not bad, f"kernel disagrees with the reference: {bad}"

    counter = _Counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[counter])
    say("kernels", gpu_tests_passed=counter.passed,
        gpu_tests_failed=counter.failed, gpu_tests_skipped=counter.skipped)
    assert rc == 0 and counter.passed > 0 and counter.skipped == 0, rc


def phase_cli():
    """Phase 8: the CLI in this process; its PNG matches the render."""
    import numpy as np
    from pbrpathtracer_tpu import api, cli
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.io.png import read_png, tonemap_to_u8
    from pbrpathtracer_tpu.scene.builders import cornell_box

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        cli.main(["render", "--builtin", "cornell", "--width", "320",
                  "--height", "240", "--spp", "4", "--depth", "3",
                  "-o", out])
        png = read_png(out)
    cfg = RenderConfig(width=320, height=240, max_depth=3, spp=4)
    ref = tonemap_to_u8(np.asarray(api.render(cornell_box(),
                                              cornell_camera(), cfg)))
    assert png.shape == ref.shape, (png.shape, ref.shape)
    assert np.array_equal(png, ref), int((png != ref).sum())
    say("cli", png_shape=list(png.shape), matches_render=True)


def four_cards():
    """--four: sharded paths on four cards against one card."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from pbrpathtracer_tpu import api
    from pbrpathtracer_tpu.diff.loss import l2_image_loss
    from pbrpathtracer_tpu.diff.params import get_params
    from pbrpathtracer_tpu.dist import multihost as mh
    from pbrpathtracer_tpu.engine.config import RenderConfig
    from pbrpathtracer_tpu.parallel.mesh import (make_mesh, ray_sharding,
                                                 replicated)
    from pbrpathtracer_tpu.parallel.render import (
        make_train_step, make_train_step_overlapped, render_sharded)
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera)
    from pbrpathtracer_tpu.scene.builders import cornell_box

    devs = jax.devices()[:4]
    mesh = make_mesh(devs)
    scene, cam = cornell_box(), cornell_camera()

    # sharded render against one card: RNG is keyed by pixel
    cfg = RenderConfig(width=1024, height=768, max_depth=3, spp=2)
    one = np.asarray(api.render(scene, cam, cfg))
    four, first = timed(lambda: render_sharded(scene, cam, cfg, mesh=mesh))
    four, warm = timed(lambda: render_sharded(scene, cam, cfg, mesh=mesh))
    four = np.asarray(four)
    d = np.abs(four - one).max(axis=-1)
    say("four_render", config="cornell 1024x768 depth3 spp2",
        bit_identical=bool(np.array_equal(four, one)),
        max_abs_diff=float(d.max()), frac_pixels_differ=float((d > 0).mean()),
        first_call_s=first, warm_s=warm)
    assert np.isfinite(four).all()
    assert np.array_equal(four, one), (float((d > 0).mean()), float(d.max()))

    # one sharded train step against the unsharded gradient
    tcfg = RenderConfig(width=256, height=256, max_depth=3, spp=1)
    params = get_params(scene, cam, materials=True)
    target = jnp.asarray(np.asarray(api.render(scene, cam, tcfg)) * 0.8)
    loss1, g1 = jax.jit(jax.value_and_grad(l2_image_loss), static_argnums=3)(
        params, scene, cam, tcfg, target, jnp.uint32(0))
    opt = optax.sgd(1.0)
    step = make_train_step(scene, cam, tcfg, opt, mesh)
    pix = jax.device_put(jnp.arange(tcfg.num_pixels, dtype=jnp.int32),
                         ray_sharding(mesh))
    tgt = jax.device_put(target.reshape(-1, 3), ray_sharding(mesh))
    p4 = jax.device_put(params, replicated(mesh))
    o4 = jax.device_put(opt.init(params), replicated(mesh))
    new_p, _, loss4 = step(p4, o4, scene, cam, pix, tgt, jnp.uint32(0))
    # sgd(1.0): the update is -grad, up to the parameter clipping
    from pbrpathtracer_tpu.diff.params import clip_params
    want = clip_params(jax.tree_util.tree_map(lambda p, g: p - g,
                                              params, g1))
    worst = 0.0
    for k in params:
        a, b = np.asarray(new_p[k]), np.asarray(want[k])
        scale = max(float(np.abs(np.asarray(g1[k])).max()), 1e-12)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    # tolerance: the psum adds the per-card gradients in another order
    # than the single-card program sums its pixels
    loss_rel = abs(float(loss4) - float(loss1)) / abs(float(loss1))
    say("four_train_step", loss_1card=float(loss1), loss_4cards=float(loss4),
        loss_rel_diff=loss_rel, max_update_err_rel_to_max_grad=worst,
        tolerance_loss_rel=1e-3, tolerance_update=1e-2)
    assert loss_rel <= 1e-3, loss_rel
    assert worst <= 1e-2, worst

    # overlapped step and the 2-D ("host", "device") mesh: finite
    ov = make_train_step_overlapped(scene, cam, tcfg.replace(spp=2),
                                    optax.adam(1e-2), mesh)
    oa = optax.adam(1e-2)
    pov, _, lov = ov(p4, jax.device_put(oa.init(params), replicated(mesh)),
                     scene, cam, pix, tgt, jnp.uint32(0))
    mesh2 = Mesh(np.array(devs).reshape(2, 2),
                 (mh.HOST_AXIS, mh.DEVICE_AXIS))
    step2 = mh.make_train_step_multihost(scene, cam, tcfg, oa, mesh=mesh2)
    sh2 = mh.wavefront_sharding(mesh2)
    p2, _, l2 = step2(jax.device_put(params, mh.replicated(mesh2)),
                      jax.device_put(oa.init(params), mh.replicated(mesh2)),
                      scene, cam,
                      jax.device_put(jnp.arange(tcfg.num_pixels,
                                                dtype=jnp.int32), sh2),
                      jax.device_put(target.reshape(-1, 3), sh2),
                      jnp.uint32(0))
    finite = all(bool(np.isfinite(np.asarray(x)).all())
                 for x in jax.tree_util.tree_leaves((pov, lov, p2, l2)))
    say("four_overlapped_and_2d", overlapped_loss=float(lov),
        mesh2d_loss=float(l2), finite=finite)
    assert finite

    # gradient psum of the textured fit on NVLink, measured
    tscene = mesh_scene(1200, textured=True, accel=None,
                        tex_size=512)
    tparams = get_params(tscene, mesh_scene_camera(), materials=True,
                         textures=True)
    nbytes = tree_bytes(tparams)
    stacked = jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.broadcast_to(x, (4,) + x.shape),
                                 NamedSharding(mesh, P("rays"))), tparams)

    @jax.jit
    def psum(t):
        return jax.shard_map(
            lambda v: jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a, "rays"), v),
            mesh=mesh, in_specs=P("rays"), out_specs=P("rays"))(t)

    jax.block_until_ready(psum(stacked))
    ts = []
    for _ in range(20):
        _, dt = timed(psum, stacked)
        ts.append(dt)
    ts.sort()
    say("four_psum", grad_bytes=nbytes, psum_median_ms=ts[10] * 1e3,
        psum_min_ms=ts[0] * 1e3, psum_max_ms=ts[-1] * 1e3,
        algbw_GB_per_s=nbytes / ts[10] / 1e9)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args()

    from pbrpathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    device = phase_device(4 if args.four else 1)
    if args.four:
        four_cards()
    else:
        phase_render()
        phase_goldens()
        phase_large()
        phase_session()
        phase_fit()
        phase_kernels()
        phase_cli()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
