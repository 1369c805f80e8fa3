"""
``chip_smoke.py`` with its speed-only profiles and timings, on one NVIDIA GPU.

    python3 scripts/chip_profiles.py

Runs every phase and check of ``chip_smoke.py`` with ``PROFILES`` on: a
profile of a serving call, of an implicit and an explicit epoch (each also
timed and profiled with the normal equations formed as before the
gather-and-Gram kernel), of the item-item scorer calls, of a FlexMF-BPR
epoch and of 5 LightGCN steps, the host Bloom build alone, and one
propagation through ``torch.sparse.mm``'s own backward and on the dense
bf16 route, timed beside the CSR route.  Prints what ``chip_smoke.py``
prints, the profiles among it; about two minutes longer.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    cs.PROFILES = True
    sys.exit(cs.main())
