"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic mix (named in BENCHMARK.json),
sets up, warms up, measures for ``--seconds``, checks what the measured
window produced against the plain reference under `benchmark/reference/`,
and prints one JSON result as the last line of standard output. Runs only
on a machine with as many CUDA devices as the cell asks for.
"""

import sys
import time

_T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent)]
    from benchlib.runner import main

    sys.exit(main(sys.argv[1:], _T0))
