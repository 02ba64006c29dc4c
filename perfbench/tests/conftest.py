"""The benchmark's own tests (CPU; the ``cuda`` ones skip without a card):

    python -m pytest perfbench/tests

Tiny cells run the drivers on the CPU with the program's plain versions.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
