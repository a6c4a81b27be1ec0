"""Run one cell of the benchmark once, on the CUDA card(s) of this machine:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``); the
numbers compared are also the last lines of standard error.  Without a
card, with fewer cards than the cell asks for, with ``jax``, ``jaxlib``,
``flax`` or ``gossip_protocol_tpu`` loaded once the window has closed,
or with a trace whose kernel events do not match its launch calls, it
prints no result and exits with 2, 2, 3 or 4.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec
    from benchmark.harness import (TraceIncomplete, banned_modules,
                                   run_cell)
    chips = spec.find(spec.load_spec()["workloads"], args.workload,
                      "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible, so no result", file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except TraceIncomplete as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 4
    found = banned_modules()
    if found:
        print(f"benchmark: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
