"""Run one cell of the port's benchmark from the root of a checkout:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the result as one JSON line, last on standard output.  The
reference's worker processes import this file again, so everything but
the start time runs under the ``__main__`` check.
"""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys
    from pathlib import Path

    ROOT = Path(__file__).resolve().parents[1]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # every compiler and kernel cache at a fixed place in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)

    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
