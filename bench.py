#!/usr/bin/env python
"""Driver shim: runs the flagship benchmark and prints ONE JSON line.

The real benchmark lives in :mod:`pbrpathtracer_tpu.bench` (importable, so
``python -m pbrpathtracer_tpu bench`` works from an installed package).
See that module's docstring for methodology (queued R-vs-2R slope timing;
canonical roofline graph).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pbrpathtracer_tpu.bench import main

if __name__ == "__main__":
    main()
