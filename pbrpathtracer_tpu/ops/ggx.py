"""GGX microfacet specular lobe — the north-star BRDF option.

The reference's only glossy model is an ad-hoc cone around the mirror
direction with a uniform-width draw (pathtracer.cpp:606-623) whose
roughness gradient is hit-flip noise (the cone boundary is a step in the
sample). ``RenderConfig.brdf="ggx"`` replaces the *opaque specular lobe*
with NDF-importance-sampled GGX (Walter et al. 2007, "Microfacet Models
for Refraction"): smooth in roughness, so inverse rendering can recover
roughness from pixels (BASELINE config 2 glossy/metal
spheres).

Estimator: sample the half vector h ∝ D(h)·cos(h), reflect. With
pdf_l = D·cos_h / (4·dot(v,h)), the throughput weight is

    f·cos_l / pdf_l = F · G2(v,l) · dot(v,h) / (cos_v · cos_h)

where F is the material's specular color (the reference's convention:
specular albedo in place of a Fresnel curve) and G2 is the separable
Smith shadowing-masking for GGX. Samples below the horizon get weight 0
(energy dropped, not redistributed — unbiased). The diffuse lobe, NEE,
Russian roulette and the translucent material keep reference semantics;
GGX only replaces the opaque specular cone.

All math is smooth jnp — reverse-mode roughness gradients are exact
pathwise derivatives, FD-checked in tests/test_ggx.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .linalg import dot, reflect, safe_normalize, safe_sqrt

TWO_PI = np.float32(2.0 * np.pi)
MIN_ALPHA = np.float32(1e-4)   # roughness 0 → near-mirror, finite grads


def orthonormal_basis(n):
    """Branchless ONB from a unit normal (Duff et al. 2017, 'Building an
    Orthonormal Basis, Revisited'). Returns (t, b) with [t, b, n] right-
    handed; no select on near-axis normals, stable gradients."""
    s = jnp.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    c = n[:, 0] * n[:, 1] * a
    t = jnp.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * c,
                   -s * n[:, 0]], axis=-1)
    b = jnp.stack([c, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=-1)
    return t, b


def _smith_g1(cos_x, alpha):
    """Separable Smith G1 for GGX: 2c / (c + sqrt(a² + (1-a²)c²))."""
    a2 = alpha * alpha
    c = jnp.abs(cos_x)
    return 2.0 * c / jnp.maximum(
        c + safe_sqrt(a2 + (1.0 - a2) * c * c), 1e-8)


def ggx_sample(rd, n, roughness, u1, u2):
    """Sample the GGX specular lobe.

    Args:
      rd: f32[N,3] incoming ray direction (pointing INTO the surface).
      n:  f32[N,3] shading normal (face-forwarded).
      roughness: f32[N] perceptual roughness; alpha = roughness².
      u1, u2: f32[N] uniform draws.

    Returns (l, w): sampled direction f32[N,3] and the scalar throughput
    weight f32[N] = G2·dot(v,h)/(cos_v·cos_h), zero for horizon-failed
    samples. Multiply by the material's specular color outside.
    """
    alpha = jnp.maximum(roughness * roughness, MIN_ALPHA)
    a2 = alpha * alpha

    # h ∝ D(h)·cos_h:  cos²θ_h = (1-u) / (1 + (a²-1)u)
    c2 = (1.0 - u1) / jnp.maximum(1.0 + (a2 - 1.0) * u1, 1e-12)
    cos_h = safe_sqrt(c2)
    sin_h = safe_sqrt(1.0 - c2)
    phi = TWO_PI * u2
    t, b = orthonormal_basis(n)
    h = safe_normalize(
        (sin_h * jnp.cos(phi))[:, None] * t
        + (sin_h * jnp.sin(phi))[:, None] * b
        + cos_h[:, None] * n)

    v = -rd
    l = reflect(rd, h)
    cos_v = dot(n, v)
    cos_l = dot(n, l)
    vh = dot(v, h)
    nh = dot(n, h)

    g2 = _smith_g1(cos_v, alpha) * _smith_g1(cos_l, alpha)
    w = g2 * vh / jnp.maximum(cos_v * nh, 1e-8)
    ok = (cos_l > 0.0) & (cos_v > 0.0) & (vh > 0.0)
    return l, jnp.where(ok, w, 0.0)
