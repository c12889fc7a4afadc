"""The benchmark's own tests, run from the repository root:

    python -m pytest benchmark/tests -q

They run on the CPU: the harness's parts, a throwaway cell, the frozen
copies against the originals, the control and the planted faults at a
small size. Tests marked ``cuda`` need a card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
