"""The readings that a cell's limits are set from: for each seed, one
process-local run of the cell (set-up, a short window at the cell's own
load, the judgement) and its control, the plain reference one precision
below the configuration's in the program's place, both compared with the
float32 reference by the same numbers.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--seconds 4] [--control-seeds 3] [--out readings.jsonl]

Each seed prints one JSON line, ``{"seed", "program", "control"}``, to
standard output and to ``--out``. The control is read on the first
``--control-seeds`` seeds only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def read(cell, seed, devices, seconds, control, overrides=None):
    """(the program's numbers, the control's or None) of one run of
    ``cell`` on ``devices``; ``overrides`` replace traffic parameters."""
    from benchmark import harness, trace

    _, config, params, drv = harness.cell_parts(harness.load_spec(), cell,
                                                overrides)
    spans = trace.Spans()
    state = drv.setup(config, params, seed, devices, spans)
    drv.window(state, seconds, trace.Slice(False, 0.0, 0))
    got = drv.judge(state, control=control)
    return got if control else (got, None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.workload(harness.load_spec(), args.workload)["chips"]
    devices = [torch.device("cuda", i) for i in range(chips)]
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        program, control = read(args.workload, seed, devices, args.seconds,
                                 k < args.control_seeds)
        line = json.dumps({"seed": seed, "program": program,
                           "control": control,
                           "s": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
