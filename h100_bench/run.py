#!/usr/bin/env python3
"""Run one cell of the H100 benchmark of ``two_pass_lanczos_tpu_torch`` once.

Usage, from the root of a checkout, on a machine with the cell's cards::

    python3 h100_bench/run.py --workload kkt500k.two_pass --seed 7 \\
        --seconds 40 --trace 0

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), ``breakdown`` (``--trace 1``), ``card``
(the card's name and power limit) and last ``checks``, each number the
check compared beside its limit; the same numbers end standard error.
Exits non-zero and prints no result without the cards the cell needs, or
if the process loaded JAX or the JAX package.

A cell of D > 1 cards: this process becomes rank 0 and starts D − 1 more
of this script with the same arguments, each told its rank by its
environment (``h100_bench/ranks.py``); rank r drives ``cuda:r``. Only rank
0 prints the result. A fault of any rank (it raises, is killed, or loads
JAX or the JAX package) ends every rank and exits non-zero with no result.
"""

import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout (the
# port's own library builds under build/torch_kernels/ there)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = os.path.join(ROOT, "build", "h100_bench", sub)
# the bytecode of every module, torch's among them, cached there too: where
# the environment writes none (PYTHONDONTWRITEBYTECODE) and the installed
# packages hold none, each run would compile torch from source, 6-9 s that
# swing from run to run
sys.pycache_prefix = os.path.join(ROOT, "build", "h100_bench", "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, ROOT)

from h100_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(started=STARTED))
