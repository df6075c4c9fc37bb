"""Progressive render session — the reference's render-thread state machine
(PathTracerLoop, main.cpp:3563-3618) as a headless object.

State machine parity:
  start()    — push the editor scene into tracer arrays, reset accumulation
               (main.cpp:3570-3586: ClearScene → SendObjectsToPathTracer →
               SetPathTracerCamera → SetResolution → ResetImage)
  pause()    — stop issuing passes; the float accumulation buffer and sample
               counter persist (pathtracer.cpp:745-753; main.cpp:3589-3594
               elapsed-time bookkeeping)
  resume()   — continue, seed-exact (absolute sample counter keys the RNG)
  stop()     — halt and clear the tracer scene (main.cpp:3132-3150)
  restart()  — re-push scene + reset accumulation
  step(n)    — render n progressive passes (1 spp each, like RenderFrame);
               chunked passes are the cooperative-cancel boundary (the
               reference checks mExit per row, pathtracer.cpp:779-780)
  target-sample auto-pause (main.cpp:3612-3616)

Observability parity (main.cpp:2245-2348 status bar): samples, avg
time/sample, elapsed (pause-aware), triangle count — via .metrics().
"""

from __future__ import annotations

import enum
import functools
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.integrator import render_accumulate, tonemap_u8
from ..scene.editor import EditorScene
from .config import RenderConfig


@functools.partial(jax.jit, static_argnames="cfg")
def _one_pass(scene, camera, accum, sample_start, cfg):
    """One progressive 1-spp pass. Scene and camera are arguments, not
    constants of the compiled pass: as constants XLA folds scene-derived
    floats on the host, a few ULPs off the device's values, which on the
    GPU flips a few hit decisions against ``render``. As arguments the
    accumulation equals ``render_accumulate`` with the summed spp bit for
    bit, and sessions on one config share one executable."""
    return render_accumulate(scene, camera, cfg, accum, sample_start, 1)


class RenderState(enum.Enum):
    IDLE = "idle"
    RENDERING = "rendering"
    PAUSED = "paused"
    STOPPED = "stopped"


class RenderSession:
    def __init__(self, editor: EditorScene | None = None,
                 cfg: RenderConfig | None = None, scene=None, camera=None):
        """Either give an editor (scene pushed on start()) or an explicit
        (scene, camera) pair."""
        self.editor = editor
        self.cfg = cfg or RenderConfig()
        self._scene = scene
        self._camera = camera
        self.state = RenderState.IDLE
        self.accum = None           # f32[N,3] running sum (mTotalImg)
        self.samples = 0            # mSamples
        self.target_samples: int | None = None
        self._time_rendering = 0.0  # accumulated active render time
        self._run_started = None
        self._cancel = threading.Event()
        self._thread = None
        self._step_fn = None

    # -- scene push (SendObjectsToPathTracer path) -------------------------
    def _push_scene(self):
        if self.editor is not None:
            self._scene = self.editor.build_scene()
            self._camera = self.editor.tracer_camera()
        if self._scene is None or self._camera is None:
            raise RuntimeError("no scene: give an editor or (scene, camera)")
        self._step_fn = functools.partial(_one_pass, cfg=self.cfg)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._push_scene()
        self.reset_image()
        self.state = RenderState.RENDERING
        self._time_rendering = 0.0
        self._run_started = time.perf_counter()

    def reset_image(self):
        """ResetImage (pathtracer.cpp:276-279, applied :745-751)."""
        n = self.cfg.width * self.cfg.height
        self.accum = jnp.zeros((n, 3), jnp.float32)
        self.samples = 0

    def pause(self):
        if self.state == RenderState.RENDERING:
            self._note_elapsed()
            self.state = RenderState.PAUSED
            self._cancel.set()

    def resume(self):
        if self.state == RenderState.PAUSED:
            self.state = RenderState.RENDERING
            self._run_started = time.perf_counter()
            self._cancel.clear()

    def stop(self):
        """Stop and clear the tracer scene (the accum buffer survives for
        export, as in the reference where stop clears PathTracer state)."""
        self._note_elapsed()
        self._cancel.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.state = RenderState.STOPPED
        self._step_fn = None
        if self.editor is not None:
            self._scene = None
            self._camera = None

    def restart(self):
        self.stop()
        self._cancel.clear()
        self.start()

    def _note_elapsed(self):
        if self.state == RenderState.RENDERING and self._run_started:
            self._time_rendering += time.perf_counter() - self._run_started
            self._run_started = None

    # -- progressive passes ------------------------------------------------
    def step(self, n_passes: int = 1) -> int:
        """Render up to n_passes progressive 1-spp passes. Returns passes
        actually run (auto-pauses at target_samples, honors cancel)."""
        if self.state != RenderState.RENDERING:
            return 0
        done = 0
        for _ in range(n_passes):
            if self._cancel.is_set():
                break
            if (self.target_samples is not None
                    and self.samples >= self.target_samples):
                self._note_elapsed()
                self.state = RenderState.PAUSED   # auto-pause (main.cpp:3612)
                break
            self.accum = self._step_fn(self._scene, self._camera, self.accum,
                                       jnp.uint32(self.samples))
            self.samples += 1
            done += 1
        return done

    def run_async(self, passes_per_chunk: int = 1):
        """Background render thread (the reference's OpenMP section B)."""
        if self.state != RenderState.RENDERING:
            self.start()

        def loop():
            while (not self._cancel.is_set()
                   and self.state == RenderState.RENDERING):
                if self.step(passes_per_chunk) == 0:
                    break
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self._thread

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- output ------------------------------------------------------------
    def image(self) -> np.ndarray:
        """Mean-radiance image f32[H,W,3]."""
        if self.accum is None or self.samples == 0:
            return np.zeros((self.cfg.height, self.cfg.width, 3), np.float32)
        img = np.asarray(self.accum) / self.samples
        return img.reshape(self.cfg.height, self.cfg.width, 3)

    def image_u8(self) -> np.ndarray:
        """Display buffer (clamp+truncate, no gamma — mOutImg parity)."""
        if self.accum is None or self.samples == 0:
            return np.zeros((self.cfg.height, self.cfg.width, 3), np.uint8)
        u8 = np.asarray(tonemap_u8(self.accum, self.samples))
        return u8.reshape(self.cfg.height, self.cfg.width, 3)

    def export_png(self, path_or_dir: str) -> str:
        from ..io.png import export_png
        return export_png(path_or_dir, self.image())

    # -- metrics (status bar parity, main.cpp:2245-2348) -------------------
    def metrics(self) -> dict:
        elapsed = self._time_rendering
        if self.state == RenderState.RENDERING and self._run_started:
            elapsed += time.perf_counter() - self._run_started
        tri_count = (self._scene.num_triangles
                     if self._scene is not None else 0)
        n_rays = self.cfg.width * self.cfg.height * max(self.samples, 0)
        return {
            "state": self.state.value,
            "samples": self.samples,
            "target_samples": self.target_samples,
            "elapsed_s": elapsed,
            "avg_time_per_sample_s": (elapsed / self.samples
                                      if self.samples else 0.0),
            "triangles": tri_count,
            "paths_per_s": (n_rays / elapsed) if elapsed > 0 else 0.0,
        }

    # -- checkpoint / resume (SURVEY.md §5) --------------------------------
    def save_checkpoint(self, path: str):
        """Serialize (accum, samples, cfg) — resume is seed-exact because
        the RNG is keyed by the absolute sample index."""
        import dataclasses
        np.savez(
            path,
            accum=np.asarray(self.accum) if self.accum is not None else
            np.zeros((0, 3), np.float32),
            samples=self.samples,
            cfg=np.array([repr(dataclasses.asdict(self.cfg))], dtype=object),
        )

    def load_checkpoint(self, path: str):
        import ast
        data = np.load(path, allow_pickle=True)
        cfg_dict = ast.literal_eval(str(data["cfg"][0]))
        self.cfg = RenderConfig(**cfg_dict)
        self.accum = jnp.asarray(data["accum"])
        self.samples = int(data["samples"])
        self._push_scene()
        self.state = RenderState.RENDERING
        self._run_started = time.perf_counter()
