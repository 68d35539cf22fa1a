"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from the
root of the repository. They run on the CPU at small sizes; those marked
`cuda` need the card and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
