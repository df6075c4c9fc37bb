"""Golden-image regression net (benchmarks/goldens.py): renders must match
the committed goldens within Monte-Carlo + float-reassociation tolerance.

Catches image drift from kernel/integrator rewrites: the RNG is keyed
(pixel, sample, bounce), so every backend draws the same estimator
samples — only ULP-level accumulation differences and the rare decision
flip (hit tie, RR edge) separate the images. Rungs 1/2/4 cover the dense
intersector, integrator, GGX and translucent paths in seconds on the CPU;
the 50k- and 200k-triangle rungs (BVH route) take minutes there, so they
are marked slow and run on the card in chip_smoke.py phase 3.
"""

import os

import numpy as np
import pytest

from benchmarks import goldens as G

NAMES = ["rung1_cornell", "rung2_spheres", "rung4_translucent",
         pytest.param("rung3_mesh50k", marks=pytest.mark.slow),
         pytest.param("rung5_million", marks=pytest.mark.slow)]


@pytest.mark.parametrize("name", NAMES)
def test_golden(name):
    path = os.path.join(G.GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"no golden recorded for {name}")
    mean, var, _cfg = G.render_one(name, G._configs()[name])
    rep = G.compare(mean, var, np.load(path))
    assert rep["ok"], rep
