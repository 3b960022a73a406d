"""The benchmark of the PyTorch/CUDA port of UPFlow: runs one cell once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  See ``benchmark/core/runner.py``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches of torch's compilers, if anything reaches them, stay in the
# checkout at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
# the checkout's root in place of this script's folder
sys.path[0] = str(ROOT)

from benchmark.core import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T0))
