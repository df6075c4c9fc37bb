"""Peak rates per device, and the speed-of-light bound of a compiled step.

``PEAKS`` is the one table of hardware rates in the repository, keyed by
``jax.devices()[0].device_kind``. A device that is not in it raises: no
peak is ever assumed. Published figures, dense, without sparsity, at the
card's full power limit; a card capped below it (``nvidia-smi``'s
``power.limit``) cannot hold its top clock under load, so report the
limit beside any share of these peaks.

The bound of a step is the larger of

  * bytes it moves (XLA's ``cost_analysis()['bytes accessed']``, the
    post-fusion buffer traffic) over peak memory bandwidth, and
  * floating-point operations over the fp32 rate outside the tensor
    cores: the renderer's geometry runs at ``Precision.HIGHEST``, which
    keeps matrix products in full fp32 (no TF32).

XLA's cost analysis does not see inside Pallas calls, so the closest-hit
kernel's arithmetic is added from its pair count (``pallas_pair_flops``),
an upper bound: chunk culling skips most pairs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    bf16_flops: float        # tensor cores, dense
    tf32_flops: float        # tensor cores, dense
    fp32_flops: float        # outside the tensor cores
    hbm_bytes_per_s: float
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        bf16_flops=989e12, tf32_flops=495e12, fp32_flops=67e12,
        hbm_bytes_per_s=3.35e12,
        source="NVIDIA H100 SXM data sheet (dense rates, 700 W)"),
}


def peaks(device_kind: str) -> Peaks:
    """Peak rates of ``device_kind``; raises KeyError when unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak rates for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


# fp32 add/sub/mul/div per (ray, triangle) pair in the Möller–Trumbore
# body of kernels/intersect_pallas.py: cross product h (9), det a (5),
# s (3), u numerator (5), cross product q (9), v and t numerators (10),
# reciprocal (1), u, v, t (3), u + v (1).
PALLAS_FLOPS_PER_PAIR = 46


@dataclasses.dataclass(frozen=True)
class Roofline:
    bytes_accessed: float        # HBM bytes, from XLA cost analysis
    xla_flops: float             # flops XLA counts
    pallas_flops: float          # analytic Pallas pair-block flops
    t_hbm_s: float
    t_fp32_s: float              # (xla_flops + pallas_flops) / fp32 peak
    t_roofline_s: float
    bound: str                   # "hbm" | "fp32"

    def fraction(self, t_measured_s: float) -> float:
        return self.t_roofline_s / max(t_measured_s, 1e-12)

    def as_dict(self, t_measured_s: float | None = None) -> dict:
        d = {
            "bytes_accessed_GB": self.bytes_accessed / 1e9,
            "xla_gflops": self.xla_flops / 1e9,
            "pallas_gflops": self.pallas_flops / 1e9,
            "t_hbm_ms": self.t_hbm_s * 1e3,
            "t_fp32_ms": self.t_fp32_s * 1e3,
            "t_roofline_ms": self.t_roofline_s * 1e3,
            "bound": self.bound,
        }
        if t_measured_s is not None:
            d["fraction_of_roofline"] = self.fraction(t_measured_s)
        return d


def pallas_pair_flops(n_rays: int, n_tris_padded: int,
                      n_queries: int) -> float:
    """Upper bound of the fp32 operations the Pallas intersector issues:
    every (ray, padded-triangle) pair, as if no chunk were culled."""
    return float(n_rays) * n_tris_padded * PALLAS_FLOPS_PER_PAIR * n_queries


def xla_costs(compiled) -> tuple[float, float]:
    """(HBM bytes, flops) from a compiled function's cost analysis."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("bytes accessed", 0.0)), float(ca.get("flops", 0.0))


def build(peak: Peaks, bytes_accessed: float, xla_flops: float,
          pallas_flops: float = 0.0) -> Roofline:
    t_hbm = bytes_accessed / peak.hbm_bytes_per_s
    t_fp32 = (xla_flops + pallas_flops) / peak.fp32_flops
    return Roofline(bytes_accessed=bytes_accessed, xla_flops=xla_flops,
                    pallas_flops=pallas_flops, t_hbm_s=t_hbm,
                    t_fp32_s=t_fp32, t_roofline_s=max(t_hbm, t_fp32),
                    bound="hbm" if t_hbm >= t_fp32 else "fp32")
