#!/usr/bin/env python
"""The Pallas closest-hit kernel against what XLA makes of the plain
intersectors, on the GPU.

    python benchmarks/kernel_bench.py [--sweep] [--sections check,query,render]

Sections (each prints JSON lines; all are appended to --out):

  check   the compiled kernel against ``intersect_classic`` at real
          widths (Cornell primary and bounce rays at 1024x768, the
          4096-triangle mesh, the 50k mesh in BVH order);
  sweep   (--sweep) rays per block, warps and chunk size of the kernel on
          two query sets; reports the fastest (the kernel's tiling is
          the constants in kernels/intersect_pallas.py);
  query   one closest-hit query: pallas vs matmul vs classic;
  render  end-to-end ``render`` per intersector: Cornell at 1024x768 and
          512², translucent 512² depth 8 and the 4096-triangle mesh at
          512² (pallas / matmul / classic); 50k and 1M triangles at 512²
          depth 3 (bvh / pallas in BVH depth-first chunk order).

Times are host wall clock around ``block_until_ready`` after one warm-up
call (which compiles); reported as the median and quartiles in ms.
Fails without a GPU.
"""

import argparse
import functools
import json
import os
import statistics
import sys
import time

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "bench_out", "kernel_bench.jsonl")


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def time_fn(fn, *args, reps):
    """(compile+first-call s, [per-call s]) of fn(*args)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, ts


def summary(ts):
    ms = sorted(t * 1e3 for t in ts)
    q = statistics.quantiles(ms, n=4) if len(ms) >= 2 else [ms[0]] * 3
    return {"median_ms": statistics.median(ms), "q1_ms": q[0],
            "q3_ms": q[2], "n": len(ms)}


def peak_bytes():
    """Process-wide peak device memory so far (monotone over a run)."""
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def cornell_camera():
    from pbrpathtracer_tpu.scene.scene import Camera
    return Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                       up=(0, 1, 0), fovy=61)


def query_rays(scene, camera, width, height, seed=0):
    """Primary camera rays and one diffuse-like bounce from their hits
    (uniform directions; lanes whose primary ray missed are dead)."""
    import jax.numpy as jnp
    from pbrpathtracer_tpu.ops.camera import generate_rays
    from pbrpathtracer_tpu.ops.intersect import intersect_classic

    pix = jnp.arange(width * height, dtype=jnp.int32)

    @jax.jit
    def make(scene):
        ro, rd = generate_rays(camera, width, height, jnp.uint32(seed),
                               jnp.uint32(0), pix)
        hit, _, t, _, _ = intersect_classic(scene.geom, ro, rd)
        p = ro + rd * (t * 0.999)[:, None]
        d = jax.random.normal(jax.random.PRNGKey(seed), ro.shape)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return (ro, rd, None), (p, d, hit)

    return make(scene)


def compare(ref, got):
    """Agreement of a closest-hit result with the reference result."""
    import numpy as np
    rh, ri, rt, ru, rv = (np.asarray(x) for x in ref)
    gh, gi, gt, gu, gv = (np.asarray(x) for x in got)
    same = (rh == gh) & (~rh | (ri == gi))
    diff = ~same
    both = rh & gh
    tie_exact = int((diff & both & (rt == gt)).sum())
    tie_near = int((diff & both
                    & (np.abs(rt - gt) <= 1e-6 * np.abs(rt))).sum())
    ids = both & (ri == gi)
    rel_t = np.abs(gt - rt)[ids] / np.maximum(np.abs(rt[ids]), 1e-30)
    abs_u = np.abs(gu - ru)[ids]
    abs_v = np.abs(gv - rv)[ids]
    return {
        "lanes": int(rh.size), "hits": int(rh.sum()),
        "agree_frac": float(same.mean()),
        "mismatch": int(diff.sum()), "mismatch_exact_tie": tie_exact,
        "mismatch_near_tie_1e-6": tie_near,
        "max_rel_err_t": float(rel_t.max()) if rel_t.size else 0.0,
        "max_abs_err_u": float(abs_u.max()) if abs_u.size else 0.0,
        "max_abs_err_v": float(abs_v.max()) if abs_v.size else 0.0,
    }


def query_sets():
    """name -> (scene, ray set, bounce flag)."""
    from pbrpathtracer_tpu.scene.builders import cornell_box, translucent_scene
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera)
    cam = cornell_camera()
    out = {}
    cb = cornell_box()
    prim, bounce = query_rays(cb, cam, 1024, 768)
    out["cornell_1024x768_primary"] = (cb, prim)
    out["cornell_1024x768_bounce"] = (cb, bounce)
    prim, bounce = query_rays(cb, cam, 512, 512)
    out["cornell_512_bounce"] = (cb, bounce)
    tr = translucent_scene()
    prim, bounce = query_rays(tr, cam, 512, 512)
    out["translucent_512_bounce"] = (tr, bounce)
    m4 = mesh_scene(4096, accel=None)
    assert m4.num_triangles <= 4096, m4.num_triangles
    prim, bounce = query_rays(m4, mesh_scene_camera(), 512, 512)
    out["mesh4096_512_primary"] = (m4, prim)
    out["mesh4096_512_bounce"] = (m4, bounce)
    return out


def _pallas(s, ro, rd, al):
    from pbrpathtracer_tpu.kernels.intersect_pallas import intersect_pallas
    return intersect_pallas(s, ro, rd, alive=al)


def _matmul(s, ro, rd, al):
    from pbrpathtracer_tpu.ops.intersect import intersect_matmul
    return intersect_matmul(s.geom, ro, rd, alive=al)


def _classic(s, ro, rd, al):
    from pbrpathtracer_tpu.ops.intersect import intersect_classic
    return intersect_classic(s.geom, ro, rd, alive=al)


RAW = {"pallas": _pallas, "matmul": _matmul, "classic": _classic}
# One jitted query per route for the whole process.
QUERY = {name: jax.jit(fn) for name, fn in RAW.items()}


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _pallas_tiled(s, ro, rd, al, chunk, block_rays, num_warps):
    """The kernel with an explicit tiling, for the sweep only."""
    from pbrpathtracer_tpu.kernels.intersect_pallas import _query
    return _query(s, ro, rd, None, al, False, chunk, block_rays, num_warps)


def check_kernel(sets):
    """The kernel against intersect_classic on every query set and on the
    50k mesh in BVH chunk order; one record per case with "ok"."""
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera)
    fns = QUERY
    cases = dict(sets)
    m50 = mesh_scene(50_000, accel="always")
    _, bounce = query_rays(m50, mesh_scene_camera(), 512, 512)
    cases["mesh50k_512_bounce_bvh_order"] = (m50, bounce)
    recs = []
    for name, (scene, (ro, rd, al)) in cases.items():
        rec = compare(fns["classic"](scene, ro, rd, al),
                      fns["pallas"](scene, ro, rd, al))
        ok = (rec["agree_frac"] >= 0.9999
              and rec["max_rel_err_t"] <= 1e-5
              and rec["max_abs_err_u"] <= 1e-5
              and rec["max_abs_err_v"] <= 1e-5)
        recs.append({"case": name, "ok": ok, **rec})
    return recs


def section_check(sets, out, label):
    recs = check_kernel(sets)
    for rec in recs:
        emit({"section": "check", **rec, **label}, out)
    return all(r["ok"] for r in recs)


def section_sweep(sets, out, label):
    """Time tilings of the kernel and report the fastest. The kernel's
    own tiling stays the module constants of kernels/intersect_pallas.py;
    the sweep says what to set them to."""
    cases = ["cornell_1024x768_bounce", "mesh4096_512_bounce"]
    best = None
    for block, warps in ((64, 2), (128, 4), (128, 2), (256, 8), (256, 4)):
        for chunk in (16, 32, 64):
            tiling = dict(block_rays=block, num_warps=warps, chunk=chunk)
            rec = {"section": "sweep", **tiling}
            total = 0.0
            for c in cases:
                scene, (ro, rd, al) = sets[c]
                _, ts = time_fn(_pallas_tiled, scene, ro, rd, al, chunk,
                                block, warps, reps=10)
                rec[c] = summary(ts)["median_ms"]
                total += rec[c]
            emit({**rec, **label}, out)
            if best is None or total < best[0]:
                best = (total, tiling)
    emit({"section": "sweep_best", **best[1], **label}, out)


def section_query(sets, out, label):
    fns = QUERY
    for name, (scene, (ro, rd, al)) in sets.items():
        for iname, f in fns.items():
            # a separate jit object for the AOT memory analysis
            mem = jax.jit(RAW[iname]).lower(
                scene, ro, rd, al).compile().memory_analysis()
            first, ts = time_fn(f, scene, ro, rd, al, reps=10)
            emit({"section": "query", "case": name, "intersector": iname,
                  "rays": int(ro.shape[0]),
                  "triangles": int(scene.num_triangles),
                  "first_call_s": first, **summary(ts),
                  "temp_bytes": int(mem.temp_size_in_bytes), **label}, out)


def render_cases():
    """(name, scene builder, camera, (width, height, depth), intersectors)."""
    from pbrpathtracer_tpu.scene.builders import cornell_box, translucent_scene
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera)
    cam = cornell_camera()
    dof = cornell_camera().replace(focal_dist=2.2, aperture=0.04)
    small = ("pallas", "matmul", "classic")
    big = ("bvh", "pallas")
    return [
        ("cornell_1024x768_d3", cornell_box, cam, (1024, 768, 3), small),
        ("cornell_512_d3", cornell_box, cam, (512, 512, 3), small),
        ("translucent_512_d8", translucent_scene, dof, (512, 512, 8), small),
        ("mesh4096_512_d3", lambda: mesh_scene(4096, accel=None),
         mesh_scene_camera(), (512, 512, 3), small),
        ("mesh50k_512_d3", lambda: mesh_scene(50_000, accel="always"),
         mesh_scene_camera(), (512, 512, 3), big),
        ("mesh1M_512_d3", lambda: mesh_scene(1_000_000, accel="always"),
         mesh_scene_camera(), (512, 512, 3), big),
    ]


def section_render(out, label, only=()):
    from pbrpathtracer_tpu import api
    from pbrpathtracer_tpu.engine.config import RenderConfig
    for name, build, camera, (w, h, d), names in render_cases():
        if only and name not in only:
            continue
        scene = build()
        for iname in names:
            cfg = RenderConfig(width=w, height=h, max_depth=d, spp=1,
                               intersector=iname)
            first, ts = time_fn(api.render, scene, camera, cfg,
                                reps=3 if scene.num_triangles > 4096 else 5)
            emit({"section": "render", "case": name, "intersector": iname,
                  "triangles": int(scene.num_triangles),
                  "first_call_s": first, **summary(ts),
                  "paths_per_s": w * h / statistics.median(ts),
                  "peak_bytes_in_use": peak_bytes(), **label}, out)
        del scene


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sections", default="check,query,render")
    ap.add_argument("--cases", default="",
                    help="comma-separated render cases (default: all)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    from pbrpathtracer_tpu.utils.compile_cache import enable_compile_cache
    from pbrpathtracer_tpu.utils.device import nvidia_smi_line, require_gpu
    enable_compile_cache()
    label = {"device": require_gpu(), "nvidia_smi": nvidia_smi_line()}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    sections = args.sections.split(",")
    ok = True
    sets = query_sets() if set(sections) - {"render"} or args.sweep else {}
    if "check" in sections:
        ok = section_check(sets, args.out, label)
    if args.sweep:
        section_sweep(sets, args.out, label)
    if "query" in sections:
        section_query(sets, args.out, label)
    if "render" in sections:
        section_render(args.out, label,
                       [c for c in args.cases.split(",") if c])
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
