"""Entry point of the benchmark: ``python benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``, from the root of a
checkout on a host with the CUDA card(s) the cell asks for (see
``harness.py``)."""

import os
import sys
import time

# set-up is timed from here: loading torch is the host's, and no change
# to the port moves it
import torch  # noqa: F401

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
