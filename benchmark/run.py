"""Run one cell of the benchmark of ``frame2frame_tpu_torch`` on the cards of
this machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled slice in the
middle of the window. The numbers that decide ``correct`` are printed with
their limits as the last lines of standard error and under ``checks``,
the result's last key. Exits with 2, and prints no result, where there is
no CUDA card or fewer than the cell asks for, or where JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.load_spec()
    chips = harness.workload(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count()} available")
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"loaded in this process, which the benchmark forbids: {found}")
        return 2
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
