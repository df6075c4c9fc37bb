#!/usr/bin/env python
"""Measure the COMPILED reference tracer (benchmarks/refbench) and compare
this framework against it on identical scenes, so the performance baseline
is a measurement rather than an estimate.

Protocol (SURVEY.md §7 hard-part 2: parity is statistical vs the C++
binary):
  * scenes are exported to OBJ (scene/obj_export.py) and loaded by BOTH
    sides through their own OBJ loaders — identical triangles by
    construction (both apply the same -X / V-flip import semantics);
  * materials are pushed programmatically on both sides from the same
    MaterialSpec values; textures are written as PNG and re-imported into
    OUR scene through scene/texture_io.py so both samplers read the same
    u8-quantized texels;
  * the reference renders spp samples (RenderFrame loop, timed around the
    whole progressive run); we render the same (res, spp, depth) on the
    current JAX backend; both display buffers use the same clamp+truncate
    u8 tonemap;
  * parity = per-channel mean difference within a Monte-Carlo error
    budget estimated from the pixel variance of the two images.

Writes REF_BASELINE.json at the repo root:
  { "host": {...}, "configs": {name: {"ref": {...}, "ours": {...},
    "parity": {...}}}}

Usage:  python benchmarks/ref_baseline.py [--quick] [--configs a,b,...]
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

warnings.filterwarnings("ignore")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BIN = os.path.join(HERE, "refbench", "refbench")
WORK = "/tmp/refbench_work"


def ensure_binary():
    if not os.path.exists(BIN):
        subprocess.run(["sh", os.path.join(HERE, "refbench", "build.sh")],
                       check=True)
    return BIN


def _material_lines(scene):
    """One driver 'material' line per material id (element ids == mat ids
    in the procedural builders; the exporter groups faces the same way)."""
    import numpy as np
    m = scene.materials
    lines = []
    n = int(np.asarray(m.mat_type).shape[0])
    for i in range(n):
        d = np.asarray(m.diffuse[i])
        s = np.asarray(m.specular[i])
        e = np.asarray(m.emissive[i])
        lines.append(
            "material {} {} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} "
            "{:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g}".format(
                i, int(m.mat_type[i]), d[0], d[1], d[2], s[0], s[1], s[2],
                e[0], e[1], e[2], float(m.emissive_intensity[i]),
                float(m.roughness[i]), float(m.reflectiveness[i]),
                float(m.translucency[i]), float(m.ior[i])))
    return lines


def _texture_lines(scene, outdir, name):
    """Write each referenced texture as PNG; returns (lines, k→path).

    Reference slot order (pathtracer.cpp:147-241): 0 diffuse, 1 normal,
    2 emissive, 3 roughness, 4 metallic, 5 opacity — matching the
    MaterialSpec.tex_index slot order."""
    import numpy as np
    from PIL import Image as PILImage
    if scene.textures is None:
        return [], {}
    lines, paths = [], {}
    tex_index = np.asarray(scene.materials.tex_index)
    data = np.asarray(scene.textures.data)
    size = np.asarray(scene.textures.size)
    for elem in range(tex_index.shape[0]):
        for slot in range(tex_index.shape[1]):
            k = int(tex_index[elem, slot])
            if k < 0:
                continue
            if k not in paths:
                w, h = int(size[k, 0]), int(size[k, 1])
                img = np.clip(np.round(data[k, :h, :w] * 255.0),
                              0, 255).astype(np.uint8)
                p = os.path.join(outdir, f"{name}_tex{k}.png")
                PILImage.fromarray(img, "RGBA").save(p)
                paths[k] = p
            lines.append(f"tex {slot} {elem} {paths[k]}")
    return lines, paths


def quantize_scene_textures(scene):
    """Snap texture masters to the u8 grid the reference samples
    (Image::tex2D divides u8 by 255, image.cpp:79-82)."""
    import jax.numpy as jnp
    if scene.textures is None:
        return scene
    t = scene.textures
    data = jnp.round(jnp.clip(t.data, 0.0, 1.0) * 255.0) / 255.0
    return scene.replace(textures=t.replace(data=data))


def run_reference(name, scene, camera, cfg, spp, threads=None):
    """Export the scene, drive the reference binary; returns (stats, u8)."""
    import numpy as np
    from pbrpathtracer_tpu.scene.obj_export import export_scene_obj

    os.makedirs(WORK, exist_ok=True)
    objp = os.path.join(WORK, f"{name}.obj")
    if not os.path.exists(objp):
        export_scene_obj(objp, scene)
    outp = os.path.join(WORK, f"{name}.u8")
    tex_lines, _ = _texture_lines(scene, WORK, name)
    spec = [
        f"obj {objp}",
        f"res {cfg.width} {cfg.height}",
        f"depth {cfg.max_depth}",
        f"spp {spp}",
        "camera {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} "
        "{:.9g} {:.9g} {:.9g}".format(*np.asarray(camera.pos),
                                      *np.asarray(camera.dir),
                                      *np.asarray(camera.up)),
        f"projection {float(camera.focal):.9g} {float(camera.fovy):.9g}",
        f"focal_dist {float(camera.focal_dist):.9g}",
        f"aperture {float(camera.aperture):.9g}",
        *_material_lines(scene),
        *tex_lines,
        f"out {outp}",
    ]
    specp = os.path.join(WORK, f"{name}.spec")
    with open(specp, "w") as f:
        f.write("\n".join(spec) + "\n")
    env = dict(os.environ)
    if threads:
        env["REFBENCH_THREADS"] = str(threads)
    r = subprocess.run([ensure_binary(), specp], capture_output=True,
                       text=True, env=env, timeout=24 * 3600)
    if r.returncode != 0:
        raise RuntimeError(f"refbench failed: {r.stderr[-2000:]}")
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    u8 = np.fromfile(outp, np.uint8).reshape(cfg.height, cfg.width, 3)
    # the reference stores bottom-up for GL (pathtracer.cpp:796); flip to
    # the top-down convention our image() uses
    u8 = u8[::-1]
    stats["threads"] = threads
    return stats, u8


def run_ours(scene, camera, cfg, spp):
    """Render with this framework; returns (stats, u8)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pbrpathtracer_tpu.api import render
    from pbrpathtracer_tpu.ops.integrator import tonemap_u8

    rcfg = cfg.replace(spp=spp)
    img = np.asarray(render(scene, camera, rcfg))   # warm (compile)
    t0 = time.perf_counter()
    img = render(scene, camera, rcfg)
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    u8 = np.asarray(tonemap_u8(jnp.asarray(img).reshape(-1, 3) * spp, spp))
    return ({"t_total_s": round(dt, 4), "t_per_sample_s": round(dt / spp, 5),
             "paths_per_s": round(cfg.width * cfg.height * spp / dt, 1),
             "backend": jax.default_backend(),
             "device": str(jax.devices()[0])},
            u8.reshape(cfg.height, cfg.width, 3))


def parity_stats(ref_u8, our_u8, spp):
    """Statistical comparison of two independently-sampled renders.

    Means differ by MC error ~ sqrt((var_a + var_b) / N) per channel
    (pixels are not iid — variance differs per pixel — so use the mean
    of the per-pixel sampling variance, bounded by the pixel variance
    itself / spp). We accept within 5 sigma + 1 u8 quantization step."""
    import numpy as np
    a = ref_u8.astype(np.float64) / 255.0
    b = our_u8.astype(np.float64) / 255.0
    n = a.shape[0] * a.shape[1]
    out = {}
    ok = True
    for c, ch in enumerate("rgb"):
        ma, mb = a[..., c].mean(), b[..., c].mean()
        # sampling std of the image mean: pixel means are independent
        # estimates; their per-pixel variance is <= pixelvar/spp, and the
        # image mean averages n of them.
        va = a[..., c].var() / max(spp, 1)
        vb = b[..., c].var() / max(spp, 1)
        sigma = float(np.sqrt((va + vb) / n))
        tol = 5.0 * sigma + 1.0 / 255.0
        diff = float(abs(ma - mb))
        out[ch] = {"ref_mean": round(float(ma), 5),
                   "our_mean": round(float(mb), 5),
                   "abs_diff": round(diff, 5), "tol": round(tol, 5),
                   "within": diff <= tol}
        ok = ok and diff <= tol
    out["rmse"] = round(float(np.sqrt(((a - b) ** 2).mean())), 5)
    out["parity_ok"] = ok
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--configs", default="cornell,mesh50k,million")
    ap.add_argument("--threads", type=int, default=0,
                    help="reference OpenMP threads (0 = all cores)")
    args = ap.parse_args()
    configs = set(args.configs.split(","))
    from pbrpathtracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import multiprocessing
    import numpy as np
    from pbrpathtracer_tpu.scene.builders import cornell_box
    from pbrpathtracer_tpu.scene.big_scenes import (mesh_scene,
                                                    mesh_scene_camera,
                                                    million_tri_scene)
    from pbrpathtracer_tpu.scene.scene import Camera
    from pbrpathtracer_tpu.engine.config import RenderConfig

    ncpu = multiprocessing.cpu_count()
    threads = args.threads or ncpu
    results = {"host": {"cpu_count": ncpu, "ref_threads": threads},
               "configs": {}}

    cam = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                      up=(0, 1, 0), fovy=61)

    if "cornell" in configs:
        # flagship config (bench.py): 512² depth-4 cornell
        scene = cornell_box()
        size = 128 if args.quick else 512
        spp = 4 if args.quick else 64
        cfg = RenderConfig(width=size, height=size, max_depth=4)
        ref, ref_u8 = run_reference("cornell", scene, cam, cfg, spp,
                                    threads=threads)
        ours, our_u8 = run_ours(scene, cam, cfg, spp)
        results["configs"]["cornell"] = {
            "workload": f"{size}x{size}@{spp}spp depth4 cornell (36 tris)",
            "ref": ref, "ours": ours,
            "parity": parity_stats(ref_u8, our_u8, spp),
            "speedup": round(ours["paths_per_s"] / ref["paths_per_s"], 2),
        }
        print(json.dumps({"config": "cornell",
                          **results["configs"]["cornell"]}), flush=True)

    if "mesh50k" in configs:
        # BASELINE config 3 (ladder rung 3): 50k tris textured, depth 3
        scene = quantize_scene_textures(mesh_scene(50_000, accel="always"))
        mcam = mesh_scene_camera()
        size = 128 if args.quick else 512
        spp = 2 if args.quick else 16
        cfg = RenderConfig(width=size, height=size, max_depth=3)
        ref, ref_u8 = run_reference("mesh50k", scene, mcam, cfg, spp,
                                    threads=threads)
        ours, our_u8 = run_ours(scene, mcam, cfg, spp)
        results["configs"]["mesh50k"] = {
            "workload": f"{size}x{size}@{spp}spp depth3 mesh50k textured",
            "ref": ref, "ours": ours,
            "parity": parity_stats(ref_u8, our_u8, spp),
            "speedup": round(ours["paths_per_s"] / ref["paths_per_s"], 2),
        }
        print(json.dumps({"config": "mesh50k",
                          **results["configs"]["mesh50k"]}), flush=True)

    if "million" in configs:
        # BASELINE config 5 geometry: ~1M tris (timing-focused; fewer spp)
        scene = quantize_scene_textures(million_tri_scene(accel="always"))
        mcam = mesh_scene_camera()
        size = 256 if args.quick else 1024
        spp = 1 if args.quick else 4
        cfg = RenderConfig(width=size, height=size, max_depth=3)
        ref, ref_u8 = run_reference("million", scene, mcam, cfg, spp,
                                    threads=threads)
        ours, our_u8 = run_ours(scene, mcam, cfg, spp)
        results["configs"]["million"] = {
            "workload": f"{size}x{size}@{spp}spp depth3 1M tris",
            "ref": ref, "ours": ours,
            "parity": parity_stats(ref_u8, our_u8, spp),
            "speedup": round(ours["paths_per_s"] / ref["paths_per_s"], 2),
        }
        print(json.dumps({"config": "million",
                          **results["configs"]["million"]}), flush=True)

    out = os.path.join(REPO, "REF_BASELINE.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
