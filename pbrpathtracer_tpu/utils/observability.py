"""Observability: structured metrics, wavefront diagnostics, profiler hooks.

The reference's only instrumentation is the status bar (samples, avg
time/sample, elapsed, triangle count — main.cpp:2245-2348) plus transient
status-text events with a 5 s TTL (main.cpp:2264-2270). This module keeps
those counters first-class and adds what an accelerator deployment needs:
per-segment
wavefront occupancy, rays/s accounting, `jax.profiler` trace capture, and
host-0-only structured logging for multi-host runs (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import json
import logging
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("pbrpathtracer_tpu")


def is_host0() -> bool:
    return jax.process_index() == 0


def log_event(event: str, **fields):
    """Host-0 structured log line (JSON) — the status-text analogue."""
    if is_host0():
        logger.info(json.dumps({"event": event, "time": time.time(),
                                **fields}))


class StatusText:
    """Transient status messages with TTL (main.cpp:2264-2270 semantics)."""

    def __init__(self, ttl_s: float = 5.0):
        self.ttl = ttl_s
        self._text = ""
        self._since = 0.0

    def set(self, text: str):
        self._text = text
        self._since = time.monotonic()
        log_event("status", text=text)

    def get(self) -> str:
        if time.monotonic() - self._since > self.ttl:
            return ""
        return self._text


def wavefront_occupancy(scene, camera, cfg, sample_idx=0):
    """Live-lane count per bounce segment — the divergence diagnostic that
    guides compaction/kernel tuning. Returns i64[num_segments]."""
    from ..ops import rng
    from ..ops.camera import generate_rays
    from ..ops.hit import closest_hit
    from ..ops.shade import WavefrontState, shade_segment

    n = cfg.width * cfg.height

    @jax.jit
    def run():
        pix = jnp.arange(n, dtype=jnp.int32)
        seed = jnp.uint32(cfg.seed)
        s_idx = jnp.uint32(sample_idx)
        ro, rd = generate_rays(camera, cfg.width, cfg.height, seed, s_idx, pix)
        state = WavefrontState.initial(ro, rd, pix)
        counts = []
        for seg in range(cfg.resolved_max_segments()):
            counts.append(jnp.sum(state.alive))
            stream = rng.bounce_stream(jnp.uint32(seg))
            hit, idx, t, u, v = closest_hit(scene, cfg, state.ro, state.rd,
                                            seed, pix, s_idx, stream)

            def shadow_trace(p, l, sh_alive=None):
                return closest_hit(scene, cfg, p, l, seed, pix, s_idx,
                                   stream,
                                   slot_base=rng.SLOT_NEE_OPACITY_BASE,
                                   alive=sh_alive)
            state = shade_segment(scene, cfg, state, hit, idx, t, u, v,
                                  jnp.uint32(seg), s_idx, seed, shadow_trace)
        return jnp.stack(counts)

    return np.asarray(run())


def rays_per_sample(occupancy: np.ndarray) -> int:
    """Issued closest-hit queries per sample: bounce + shadow per live lane."""
    return int(occupancy.sum()) * 2


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/ptx_profile"):
    """Capture a jax.profiler trace around a block (view with TensorBoard
    or xprof). Replaces the reference's glfwSetTime wall-clock readouts with
    real device timelines."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def auto_resolution(base_width: int, base_height: int, aspect: float):
    """Auto-res (main.cpp autoRes): keep the pixel budget of
    (base_width × base_height), match the viewport aspect ratio."""
    budget = base_width * base_height
    w = int(round((budget * aspect) ** 0.5))
    h = max(1, int(round(w / aspect)))
    return max(1, w), h
