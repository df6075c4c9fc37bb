"""Command-line interface — the headless replacement for the reference's
app shell (main(): CLI .pts arg, render control keys, PNG export,
main.cpp:3649-3687 / 3039-3221).

    python -m pbrpathtracer_tpu render scene.pts -o out.png --spp 64
    python -m pbrpathtracer_tpu render --builtin cornell --spp 32
    python -m pbrpathtracer_tpu info scene.pts
    python -m pbrpathtracer_tpu fit --builtin cornell --steps 50
    python -m pbrpathtracer_tpu bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_render_args(p):
    p.add_argument("scene", nargs="?", help=".pts or .obj path")
    p.add_argument("--builtin", choices=["cornell", "cornell-spheres",
                                         "translucent"],
                   help="procedural test scene instead of a file")
    p.add_argument("-o", "--out", default=".",
                   help="output PNG path or directory (auto-name)")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "pallas", "matmul", "classic", "bvh"])
    p.add_argument("--aspect", type=float, default=None,
                   help="viewport aspect ratio for .pts scenes with autoRes "
                        "(keeps the stored pixel budget, matches this aspect "
                        "— main.cpp autoRes semantics)")
    p.add_argument("--auto-segments", action="store_true",
                   help="size the wavefront segment cap from the scene's RR "
                        "survival statistics (bounds specular-chain "
                        "truncation bias below 1e-3; see "
                        "engine.config.suggest_max_segments)")


def _builtin_scene(name):
    from .scene import builders
    from .scene.scene import Camera
    scene = {"cornell": builders.cornell_box,
             "cornell-spheres": builders.cornell_spheres_scene,
             "translucent": builders.translucent_scene}[name]()
    camera = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                         up=(0, 1, 0), fovy=61)
    return scene, camera


def _load_any(args):
    from .engine.config import RenderConfig
    if args.builtin:
        scene, camera = _builtin_scene(args.builtin)
        cfg = RenderConfig(width=args.width or 512, height=args.height or 512,
                           max_depth=args.depth or 3, spp=args.spp,
                           seed=args.seed, intersector=args.intersector)
        return scene, camera, cfg
    if not args.scene:
        raise SystemExit("error: give a scene file or --builtin")
    if args.scene.endswith(".pts"):
        from .scene.pts import load_pts
        editor, settings = load_pts(args.scene)
        if settings["missing_objects"]:
            raise SystemExit(
                f"error: missing OBJ assets: {settings['missing_objects']}")
        width, height = settings["width"], settings["height"]
        # autoRes (main.cpp:1463-1512): resolution follows the viewport.
        # Headless: keep the stored pixel budget, match --aspect.
        if settings["auto_res"] and getattr(args, "aspect", None) \
                and not (args.width or args.height):
            from .utils.observability import auto_resolution
            width, height = auto_resolution(width, height, args.aspect)
        cfg = RenderConfig(
            width=args.width or width,
            height=args.height or height,
            max_depth=args.depth or settings["trace_depth"],
            spp=args.spp, seed=args.seed, intersector=args.intersector)
        return editor.build_scene(), editor.tracer_camera(), cfg
    # bare OBJ: default material + auto-framed camera
    from .scene.editor import EditorScene
    ed = EditorScene()
    if not ed.load_object(args.scene):
        raise SystemExit(f"error: cannot load {args.scene}")
    cfg = RenderConfig(width=args.width or 512, height=args.height or 512,
                       max_depth=args.depth or 3, spp=args.spp,
                       seed=args.seed, intersector=args.intersector)
    return ed.build_scene(), ed.tracer_camera(), cfg


def cmd_render(args):
    import numpy as np
    from .api import export_png, render
    scene, camera, cfg = _load_any(args)
    if getattr(args, "auto_segments", False):
        cfg = cfg.with_auto_segments(scene)
    t0 = time.time()
    img = np.asarray(render(scene, camera, cfg))
    dt = time.time() - t0
    path = export_png(args.out, img)
    n_paths = cfg.width * cfg.height * cfg.spp
    print(f"rendered {cfg.width}x{cfg.height}@{cfg.spp}spp depth "
          f"{cfg.max_depth} in {dt:.2f}s ({n_paths/dt/1e6:.2f}M paths/s) "
          f"-> {path}")


def cmd_info(args):
    from .scene.pts import load_pts
    editor, settings = load_pts(args.scene, load_objects=not args.no_assets)
    info = {
        "trace_depth": settings["trace_depth"],
        "resolution": [settings["width"], settings["height"]],
        "auto_res": settings["auto_res"],
        "missing_objects": settings["missing_objects"],
        "camera": {
            "position": [float(x) for x in editor.cam_pos],
            "rotation": [float(x) for x in editor.cam_rot],
            "focal_dist": editor.cam_focal_dist,
            "f_number": editor.cam_f,
        },
        "objects": [{
            "name": o.name, "file": o.filename,
            "location": list(o.location), "rotation": list(o.rotation),
            "scale": list(o.scale),
            "elements": [{
                "name": e.name,
                "type": ["OPAQUE", "TRANSLUCENT"][e.material.mat_type],
                "textures": {k: p for k, p in zip(
                    ("diffuse", "normal", "emissive", "roughness",
                     "metallic", "opacity"), e.texture_paths) if p},
            } for e in o.elements],
        } for o in editor.objects],
    }
    if not args.no_assets:
        info["triangles"] = editor.triangle_count()
    print(json.dumps(info, indent=2))


def cmd_fit(args):
    import numpy as np
    from .api import fit, render
    scene, camera, cfg = _load_any(args)
    cfg = cfg.replace(spp=args.spp)
    if args.target:
        from PIL import Image
        target = np.asarray(Image.open(args.target).convert("RGB"),
                            np.float32) / 255.0
    else:
        print("no --target: self-calibration demo (fit to own render)")
        target = np.asarray(render(scene, camera, cfg))
    res = fit(scene, camera, cfg, target, steps=args.steps, lr=args.lr,
              materials=True, camera_lens=args.fit_camera,
              callback=lambda s, l, p: print(f"step {s}: loss {l:.6f}")
              if s % 10 == 0 else None)
    print(f"final loss: {res.losses[-1]:.6f}")
    if args.save_params:
        np.savez(args.save_params,
                 **{k: np.asarray(v) for k, v in res.params.items()})
        print(f"saved fitted params -> {args.save_params}")


def cmd_bench(args):
    from .bench import main as bench_main
    bench_main()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pbrpathtracer_tpu",
        description="differentiable PBR path tracer")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("info", help="inspect a .pts scene file")
    p.add_argument("scene")
    p.add_argument("--no-assets", action="store_true",
                   help="don't load the OBJ files")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("fit", help="inverse-rendering fit")
    _add_render_args(p)
    p.add_argument("--target",
                   help="target image, read with Pillow (default: self-render)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--fit-camera", action="store_true")
    p.add_argument("--save-params")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("bench", help="run the GPU benchmark")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
