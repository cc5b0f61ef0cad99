"""Run one cell of the benchmark on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
run's JSON result; the last lines of standard error the numbers the check
compared, each beside its limit. Exits non-zero, with no result, where
the card is missing, where the run loaded JAX or the JAX package, or
where a traced run's reader found nothing to read.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache in a fixed directory of the checkout: the
# port's nvcc libraries go to build/quadruped_gym_tpu_torch/ (its own
# fixed path), the rest here
_CACHE = os.path.join(ROOT, "build", "bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
# Python's bytecode too: where the interpreter keeps no bytecode beside
# PyTorch's sources (a read-only install, PYTHONDONTWRITEBYTECODE), every
# run would compile all of PyTorch's modules again, seconds of host work
# that set-up would pay and a busy host would stretch
sys.pycache_prefix = os.path.join(_CACHE, "pycache")
sys.dont_write_bytecode = False
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
