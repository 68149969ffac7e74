"""Readings of the comparison that sets a bdpt cell's limits, in one
process: ``portbench/control.py`` with the plain reference of bdpt
(``reference/bdpt.py``) in the place of the path tracer's.

    python -m portbench.control_bdpt --workload 0002_mb_bdpt.progressive_bdpt \
        --seeds 1,2,... [--control-seeds 7,8,9] [--size WxH]

The program's readings are its calls against the reference; the
control's are the reference with each subpath vertex record rounded to
bfloat16 (``reference.bdpt.progression(lowp=True)``) against the
reference.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import sys

from portbench import control
from portbench.reference import bdpt


def main(argv=None):
    control.reference = bdpt       # SIDE and progression, as control reads
    return control.main(argv)


if __name__ == '__main__':
    sys.exit(main())
