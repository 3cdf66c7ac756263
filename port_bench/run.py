"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's inputs from the seed,
sets up and warms up the port (``nonlinear_optimizer_for_slam_tpu_torch``,
imported from the checkout's root; its kernels build into ``build/`` there
on the first run), serves the cell's traffic for ``--seconds``, compares
the answers with the plain reference under ``port_bench/reference/``, and
prints the result as the last line of standard output, the numbers
compared beside their limits as the last lines of standard error. With
``--trace 1`` the first seconds of the window run under the profiler and
the line carries the per-layer metrics and the breakdown.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), or when a module of JAX or of the JAX
package is loaded at the end of the run.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from harness import guard, report, runner  # noqa: E402
from harness.manifest import Manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    cell = Manifest(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = torch.cuda.get_device_name(0)
    runner.log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    sys.path.insert(1, str(ROOT))  # the port's package, at the checkout's root
    out = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), _T0)
    found = guard.banned_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    report.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
