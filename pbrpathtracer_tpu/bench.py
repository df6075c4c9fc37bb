"""Benchmark: forward+backward rays/s per card on the flagship workload.

Importable entry point (``python -m pbrpathtracer_tpu bench`` works from an
installed package); the repo-root ``bench.py`` shim calls :func:`main`.
BASELINE.json metric: "rays/s/chip fwd+bwd at 1spp bounce-4". Fails
without a GPU; every result names the device (platform, device_kind,
count) and the card's power limit.

Timing: a queued host loop — R back-to-back async dispatches, one final
block_until_ready — measured at R and 2R and differenced, so fixed costs
(dispatch, queue ramp) cancel and the slope is device throughput.

Speed-of-light: `utils/roofline.py` prices HBM traffic (XLA cost
analysis) and fp32 operations (XLA counters + the Pallas pair-block
arithmetic XLA can't see) at the card's peak rates from its one table;
``fraction_of_roofline`` in the output is measured-vs-that-bound. The
cost analysis is taken from a canonical graph — rolled scan over the
measured number of live segments only (the executed graph's trailing
all-dead segments are skipped by lax.cond, so the minimal schedule omits
them), no dead-skip cond, remat="hits" for fwd+bwd (query outputs stashed
as residuals, so each query executes once, matching the single-count
Pallas-flops term). All three denominators (bytes, XLA flops, Pallas
flops) come from this one schedule.

``vs_baseline`` compares our forward paths/s on the flagship cornell
config against the reference binary (benchmarks/refbench, measured by
benchmarks/ref_baseline.py into REF_BASELINE.json), normalized to a
16-core desktop (measured per-core throughput x 13 worker threads, the
reference's own num_threads heuristic at 16 cores). Falls back to a
~5e6 rays/s estimate only when REF_BASELINE.json is absent.

Ray accounting: per sample and segment, one bounce closest-hit query and
one NEE shadow query per *live* lane; dead-lane slots are not credited.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
"""

import json
import time
import warnings

REFERENCE_CPU_RAYS_PER_S = 5.0e6  # fallback estimate, see module docstring

WIDTH = HEIGHT = 512
DEPTH = 4
SPP = 1


def reference_baseline():
    """Measured reference-binary throughput from REF_BASELINE.json.

    Returns (per-chip-comparable paths/s for a 16-core desktop, info
    dict) or (None, {...}) when no measurement exists. The reference
    reserves 3 threads for its UI (pathtracer.cpp:768-774), so a
    16-core desktop runs 13 workers; this box's measurement is
    per-core-scaled accordingly."""
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "REF_BASELINE.json")
    if not os.path.exists(path):
        return None, {"vs_baseline_is_estimate": True,
                      "baseline_assumption":
                          "ref CPU ~5e6 rays/s (16-core OpenMP)"}
    with open(path) as f:
        data = json.load(f)
    cfg = data.get("configs", {}).get("cornell")
    if not cfg:
        return None, {"vs_baseline_is_estimate": True,
                      "baseline_assumption":
                          "ref CPU ~5e6 rays/s (16-core OpenMP)"}
    ref = cfg["ref"]
    threads = ref.get("threads") or data["host"]["ref_threads"]
    per_core = ref["paths_per_s"] / max(threads, 1)
    ref_16core = per_core * 13  # 16-core desktop -> 13 worker threads
    return ref_16core, {
        "vs_baseline_is_estimate": False,
        "baseline_source": "REF_BASELINE.json (compiled reference core, "
                           "benchmarks/refbench)",
        "ref_measured_paths_per_s": ref["paths_per_s"],
        "ref_measured_threads": threads,
        "ref_paths_per_s_16core_proj": round(ref_16core, 1),
        "ref_workload": cfg.get("workload"),
        "ref_parity_ok": cfg.get("parity", {}).get("parity_ok"),
    }


def measure_flagship(extra_workloads=True):
    """Run the flagship measurement; returns the result dict."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .scene.builders import cornell_box
    from .scene.scene import Camera
    from .engine.config import RenderConfig
    from .ops.integrator import render_sample
    from .ops import rng
    from .ops.camera import generate_rays
    from .ops.hit import closest_hit, _resolve_intersector_name
    from .ops.shade import WavefrontState, shade_segment
    from .diff.params import get_params
    from .diff.loss import l2_image_loss
    from .utils import roofline
    from .utils.device import nvidia_smi_line, require_gpu

    device = require_gpu()
    peak = roofline.peaks(device["kind"])

    scene = cornell_box()
    camera = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                         up=(0, 1, 0), fovy=61)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH, spp=SPP,
                       seed=0)
    n_pix = WIDTH * HEIGHT

    # --- instrument live-lane occupancy to count issued rays ---------------
    @jax.jit
    def occupancy():
        pix = jnp.arange(n_pix, dtype=jnp.int32)
        seed = jnp.uint32(0)
        ro, rd = generate_rays(camera, WIDTH, HEIGHT, seed, jnp.uint32(0), pix)
        state = WavefrontState.initial(ro, rd, pix)
        counts = []
        for seg in range(cfg.resolved_max_segments()):
            counts.append(jnp.sum(state.alive))
            stream = rng.bounce_stream(jnp.uint32(seg))
            hit, idx, t, u, v = closest_hit(scene, cfg, state.ro, state.rd,
                                            seed, pix, jnp.uint32(0), stream)

            def shadow_trace(p, l, sh_alive=None):
                return closest_hit(scene, cfg, p, l, seed, pix, jnp.uint32(0),
                                   stream, alive=sh_alive,
                                   slot_base=rng.SLOT_NEE_OPACITY_BASE)
            state = shade_segment(scene, cfg, state, hit, idx, t, u, v,
                                  jnp.uint32(seg), jnp.uint32(0), seed,
                                  shadow_trace)
        return jnp.stack(counts)

    live = np.asarray(occupancy())
    rays_per_sample = int(live.sum()) * 2  # bounce + shadow query per live lane
    live_segments = int((live > 0).sum())  # skip_dead skips the rest

    # --- queued-loop timing (R vs 2R slope; see module docstring) ----------
    def devtime(step_jit, args_of, reps):
        def run(n):
            out = step_jit(*args_of(0))
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            outs = [step_jit(*args_of(i)) for i in range(n)]
            jax.block_until_ready(outs[-1])
            return time.perf_counter() - t0
        t1 = run(reps)
        t2 = run(2 * reps)
        return (t2 - t1) / reps

    params = get_params(scene, camera, materials=True)
    target = jnp.zeros((HEIGHT, WIDTH, 3), jnp.float32)

    fwd_jit = jax.jit(lambda s: jnp.sum(render_sample(
        scene, camera, cfg, jnp.uint32(0), seed=s)))
    fb_jit = jax.jit(lambda p, s: jax.value_and_grad(l2_image_loss)(
        p, scene, camera, cfg, target, s))

    t_fwd = devtime(fwd_jit, lambda i: (jnp.uint32(i),), reps=24)
    t_fwdbwd = devtime(fb_jit, lambda i: (params, jnp.uint32(i)), reps=12)

    # --- roofline (speed-of-light) readout ---------------------------------
    # Canonical graph (see module docstring): rolled scan over the LIVE
    # segments only, no dead-skip cond; "hits" remat for fwd+bwd so each
    # query executes once — the same schedule all three cost terms price.
    cfg_roof = cfg.replace(skip_dead_segments=False, unroll_segments=1,
                           max_segments=max(live_segments, 1))
    roof_fwd_jit = jax.jit(lambda s: render_sample(scene, camera, cfg_roof,
                                                   jnp.uint32(0), seed=s))
    bytes_fwd, flops_fwd = roofline.xla_costs(
        roof_fwd_jit.lower(jnp.uint32(0)).compile())
    cfg_roof_fb = cfg_roof.replace(remat_segments="hits")
    roof_fb_jit = jax.jit(lambda p, s: jax.value_and_grad(l2_image_loss)(
        p, scene, camera, cfg_roof_fb, target, s))
    bytes_fb, flops_fb = roofline.xla_costs(
        roof_fb_jit.lower(params, jnp.uint32(0)).compile())

    # Pallas pair-block flops XLA can't see: two queries per live segment,
    # every lane x padded-tri pair — executed exactly once each under the
    # canonical schedule (forward; "hits" remat keeps the backward
    # query-free).
    if _resolve_intersector_name(scene, cfg) == "pallas":
        from .kernels.intersect_pallas import CHUNK
        t_pad = -(-scene.num_triangles // CHUNK) * CHUNK
        pf = roofline.pallas_pair_flops(n_pix, t_pad, 2 * live_segments)
    else:
        pf = 0.0
    rl_fwd = roofline.build(peak, bytes_fwd, flops_fwd, pf)
    rl_fb = roofline.build(peak, bytes_fb, flops_fb, pf)

    # --- deep translucent workload (depth 8, 18 segments, occupancy decay
    # to ~1%): the segment-cap + RR-refund semantics under a perf lens.
    # One fwd measurement, same canonical timing.
    deep = {}
    if extra_workloads:
        from .scene.builders import translucent_scene
        dscene = translucent_scene()
        dcam = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                           up=(0, 1, 0), fovy=61, focal_dist=2.2,
                           aperture=0.04)
        dcfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=8, spp=1,
                            seed=0)
        dfwd = jax.jit(lambda s: jnp.sum(render_sample(
            dscene, dcam, dcfg, jnp.uint32(0), seed=s)))
        t_deep = devtime(dfwd, lambda i: (jnp.uint32(i),), reps=12)
        from .utils.observability import wavefront_occupancy
        occ = wavefront_occupancy(dscene, dcam, dcfg)
        deep = {
            "deep_t_fwd_ms": t_deep * 1e3,
            "deep_rays_per_s": 2 * int(occ.sum()) / t_deep,
            "deep_config": f"{WIDTH}x{HEIGHT}@1spp depth8 translucent "
                           f"({dcfg.resolved_max_segments()} segments)",
        }

    # --- big-scene throughput --------------------------------------------
    bigscene = {}
    if extra_workloads:
        from .scene.big_scenes import mesh_scene, mesh_scene_camera
        mcam = mesh_scene_camera()
        for label, ntris in (("50k", 50_000), ("1M", 1_000_000)):
            bscene = mesh_scene(ntris, accel="always")
            bcfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3,
                                spp=1)
            bjit = jax.jit(lambda s, _sc=bscene, _c=bcfg: jnp.sum(
                render_sample(_sc, mcam, _c, jnp.uint32(0), seed=s)))
            t_b = devtime(bjit, lambda i: (jnp.uint32(i),), reps=3)
            bigscene[f"paths_per_s_{label}tris"] = n_pix / t_b
            bigscene[f"t_sample_{label}tris_ms"] = t_b * 1e3
            del bscene, bjit

    rays_fwd = rays_per_sample / t_fwd
    rays_fwdbwd = rays_per_sample / t_fwdbwd
    value = rays_fwdbwd

    # measured baseline (compiled reference binary) when available;
    # vs_baseline compares like-for-like: OUR forward paths/s on the
    # flagship config vs the reference's paths/s (16-core projection)
    ref_paths, ref_info = reference_baseline()
    if ref_paths is not None:
        vs_baseline = (n_pix * SPP / t_fwd) / ref_paths
    else:
        vs_baseline = value / REFERENCE_CPU_RAYS_PER_S

    return {
        "metric": "rays_per_s_per_chip_fwd_bwd",
        "value": value,
        "unit": "rays/s",
        "vs_baseline": vs_baseline,
        "extras": {
            "rays_per_s_fwd": rays_fwd,
            "paths_per_s_fwd": n_pix * SPP / t_fwd,
            "t_fwd_ms": t_fwd * 1e3,
            "t_fwdbwd_ms": t_fwdbwd * 1e3,
            "timing": "queued-loop R-vs-2R slope (fixed costs cancelled)",
            "roofline_graph": "canonical rolled/noskip over live segments, "
                              "remat-hits for fwd+bwd (all cost terms from "
                              "this one schedule; see module docstring)",
            "roofline_fwd": rl_fwd.as_dict(t_fwd),
            "roofline_fwdbwd": rl_fb.as_dict(t_fwdbwd),
            "live_per_segment": live.tolist(),
            "config": f"{WIDTH}x{HEIGHT}@{SPP}spp depth{DEPTH} cornell",
            "device": device,
            "nvidia_smi": nvidia_smi_line(),
            "peaks_source": peak.source,
            **ref_info,
            **bigscene,
            **deep,
        },
    }


def main():
    warnings.filterwarnings("ignore")
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(json.dumps(measure_flagship()))


if __name__ == "__main__":
    main()
