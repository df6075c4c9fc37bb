"""pbrpathtracer_tpu — a differentiable PBR path-tracing framework
(JAX/XLA/Pallas) with the capabilities of the reference C++ CPU tracer
JCSaltFish/PBRPathTracer, re-architected as a megakernel-free wavefront
renderer that runs on NVIDIA GPUs. See SURVEY.md for the blueprint and the api module for
the public surface."""

from .api import (  # noqa: F401
    Camera, EditorScene, MaterialSpec, RenderConfig, RenderSession,
    RenderState, Scene, builders, export_png, fit,
    get_resolution_from_scene_file, get_params, grad_render, l2_image_loss,
    load_pts, loss_and_grad, render, render_pts, save_pts, set_params,
)

__version__ = "0.1.0"
