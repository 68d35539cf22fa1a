"""Operation counts of the CIEDE2000 kernels, beside those of
perfbench/roofline/__init__.py.

Copied from `chip_smoke.py` (CIEDE_OPS_PER_PX): per pixel and candidate,
141 float32 operations of CIEDE2000 (csrc/ciede2000.cuh) with the win test
and the pooled sums, plus its nine transcendentals (two atan2, two sin,
four cos, one exp), each counted as one float32 operation, the fewest any
implementation takes. The function needs float32 only; the kernels take
the transcendentals in double to round as their twins do, which is the
port's choice and not part of the work bounded here.
"""

CIEDE_OPS_PER_PX = 141 + 9
