"""One run of one benchmark cell of the PyTorch and CUDA port:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Prints one JSON line last on standard output; see README.md.
"""

import sys
import time

T_PROCESS = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    # the checkout's root, not this directory, on the path: the package is
    # imported as ``portbench``
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from portbench import harness

    sys.exit(harness.main(t_process=T_PROCESS))
