"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``coponerf_tpu_torch``)
on a machine with the CUDA cards the cell asks for.  ``setup_s`` counts
from the first line of this file.  The kernels' build and every cache stay
inside the checkout: the port's ``coponerf_tpu_torch/_build/`` and, for
anything built through torch or Triton, ``.portbench_cache/``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = ROOT   # not this folder: its modules would shadow the standard library's

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
