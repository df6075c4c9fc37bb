"""Counter-based RNG for the wavefront path tracer.

The reference uses a single shared ``std::mt19937`` consumed from all OpenMP
worker threads without synchronization (pathtracer.h:75, pathtracer.cpp:367-371),
which makes its renders non-deterministic across runs and thread counts. Per the
blueprint (SURVEY.md §2.2, §5) determinism is restored here with a *counter-based*
generator keyed by ``(pixel, sample, stream, slot)``: every random decision in the
render has a fixed key, independent of evaluation order, so

* the JAX wavefront renderer and the numpy CPU oracle draw *identical* numbers
  (they share this module — the math below is plain uint32 arithmetic that
  numpy and jnp evaluate bit-identically), and
* pause/resume and re-sharding are seed-exact.

Generator: ``pcg4d`` (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) — 4-word LCG + cross-multiply mix; high-quality and cheap
(integer multiply-add + shifts only).
"""

import numpy as np

# ---------------------------------------------------------------------------
# Slot layout
# ---------------------------------------------------------------------------
# Each logical random draw in the render has a fixed (stream, slot) address.
# Streams: 0 = camera/lens, 1 + b = bounce segment b (one segment per Trace()
# invocation in the reference recursion, pathtracer.cpp:545).
# The counter passed to the hash is  stream * SLOTS_PER_STREAM + slot.

SLOTS_PER_STREAM = 32

STREAM_CAMERA = 0


def bounce_stream(segment):
    """Stream id for bounce segment ``segment`` (0-based)."""
    return 1 + segment


# Camera stream slots (RenderFrame DOF, pathtracer.cpp:787-791 via SampleCircle
# :734-739 — angle then radius).
SLOT_LENS_ANGLE = 0
SLOT_LENS_RADIUS = 1

# Bounce-stream slots. One Trace() call consumes at most one draw per slot;
# draws are keyed, not sequential, so branches that skip a draw do not shift
# the others (unlike the reference's sequential mt19937 stream).
SLOT_OPACITY_BASE = 0       # 0..3: stochastic alpha re-trace attempts (Hit, pathtracer.cpp:469-476)
SLOT_RR = 4                 # Russian roulette (pathtracer.cpp:590-594)
SLOT_LOBE_SELECT = 5        # opaque: Rand() < reflectiveness (pathtracer.cpp:601)
SLOT_LOBE_W = 6             # hemisphere/cone sample w (pathtracer.cpp:609,621,634,...)
SLOT_LOBE_THETA = 7         # hemisphere/cone sample theta
SLOT_REFRACT_CONE_W = 8     # translucent rough refraction-normal cone (pathtracer.cpp:651)
SLOT_REFRACT_CONE_THETA = 9
SLOT_FRESNEL = 10           # Schlick test (pathtracer.cpp:669)
SLOT_REFLECTIVENESS = 11    # translucent reflectiveness test (pathtracer.cpp:671)
SLOT_TRANSLUCENCY = 12      # refract vs diffuse (pathtracer.cpp:706)
SLOT_NEE_LIGHT = 13         # light-triangle pick (pathtracer.cpp:509)
SLOT_NEE_U = 14             # SampleTriangle u (pathtracer.cpp:496)
SLOT_NEE_V = 15             # SampleTriangle v (pathtracer.cpp:497)
SLOT_NEE_OPACITY_BASE = 16  # 16..19: shadow-ray alpha re-trace attempts

MAX_OPACITY_ATTEMPTS = 4


# ---------------------------------------------------------------------------
# pcg4d core — dtype-generic: works on numpy *and* jax.numpy uint32 arrays.
# ---------------------------------------------------------------------------

def _u32(x):
    return x.astype(np.uint32) if hasattr(x, "astype") else np.uint32(x)


def pcg4d(a, b, c, d):
    """4-in/4-out pcg4d hash. Inputs broadcastable uint32 arrays (np or jnp)."""
    m = np.uint32(1664525)
    k = np.uint32(1013904223)
    with np.errstate(over="ignore"):  # numpy scalar path: u32 wrap is intended
        x = _u32(a) * m + k
        y = _u32(b) * m + k
        z = _u32(c) * m + k
        w = _u32(d) * m + k
        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
        x = x ^ (x >> np.uint32(16))
        y = y ^ (y >> np.uint32(16))
        z = z ^ (z >> np.uint32(16))
        w = w ^ (w >> np.uint32(16))
        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
    return x, y, z, w


def _to_unit(x):
    # Top 24 bits -> [0, 1). float32 can represent all 2^24 values exactly.
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / 16777216.0)


def rand_uniform(seed, pixel, sample, ctr):
    """One uniform float32 in [0, 1) keyed by (seed, pixel, sample, ctr).

    All arguments broadcast; the result has the broadcast shape, dtype
    float32. Works identically for numpy and jax inputs (the oracle passes
    scalars/numpy, the renderer jnp arrays).
    """
    x, _, _, _ = pcg4d(pixel, sample, ctr, seed)
    return _to_unit(x)


def rand_slots4(seed, pixel, sample, stream, group):
    """Four uniforms for slots (4g, 4g+1, 4g+2, 4g+3) from ONE pcg4d eval.

    pcg4d's four output words are independently usable (Jarzynski & Olano
    §3.4), so each hash serves a whole slot *group*, which quarters the
    RNG cost of a bounce segment (slots 4-15 are exactly groups 1-3). The
    slot layout above is grouped so that draws consumed together share a
    group.
    """
    with np.errstate(over="ignore"):
        ctr = (_u32(stream) * np.uint32(SLOTS_PER_STREAM)
               + _u32(group) * np.uint32(4))
    x, y, z, w = pcg4d(pixel, sample, ctr, seed)
    return _to_unit(x), _to_unit(y), _to_unit(z), _to_unit(w)


def rand_slot(seed, pixel, sample, stream, slot):
    """Uniform draw for a (stream, slot) address.

    Routed through the same group hash as ``rand_slots4`` so a renderer that
    batches draws by group and an oracle that draws slot-by-slot read the
    *identical* value for every (stream, slot). ``slot`` must be static
    (python/numpy integer) — every call site uses layout constants.
    """
    group = slot // 4
    sel = int(slot % 4)
    return rand_slots4(seed, pixel, sample, stream, group)[sel]
