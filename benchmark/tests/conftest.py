"""The benchmark's own tests: its arithmetic, its manifest, its imports,
and a run of each cell at a tiny size on the CPU. From the root of the
repository: ``python -m pytest -q -p no:cacheprovider benchmark/tests``."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
