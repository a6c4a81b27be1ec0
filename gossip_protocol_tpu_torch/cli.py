"""Command-line entry point, CLI-compatible with the reference binary.

    python -m gossip_protocol_tpu_torch testcases/singlefailure.conf [--device cpu]

writes dbg.log / stats.log / msgcount.log into the output directory,
byte-identical to ``python -m gossip_protocol_tpu`` for the same config
and seed.  Flags are the JAX CLI's (``--seed``, ``-n``, ``--ticks``,
``--outdir``, ``--bench``, ``--quiet``, ``--model``, ``--topology``)
with ``--device`` (default ``cuda``) in place of ``--platform``.
``--model overlay`` raises: the overlay family is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

from .addressing import display_addr
from .config import SimConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gossip_protocol_tpu_torch",
        description="gossip membership-protocol simulator (PyTorch/CUDA)")
    ap.add_argument("conf", help="testcase .conf file (reference format)")
    ap.add_argument("--seed", type=int, default=None,
                    help="PRNG seed (default: from config; pass --seed -1 "
                         "for wall-clock seeding like the reference)")
    ap.add_argument("-n", "--peers", type=int, default=None,
                    help="override MAX_NNB (scale the scenario)")
    ap.add_argument("--ticks", type=int, default=None,
                    help="override TOTAL_RUNNING_TIME (default 700)")
    ap.add_argument("--outdir", default=".",
                    help="directory for dbg.log/stats.log/msgcount.log")
    ap.add_argument("--bench", action="store_true",
                    help="benchmark mode: no logs, print one JSON line")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-node introduction stdout lines")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises when none is "
                         "visible) or on the CPU with the plain versions")
    ap.add_argument("--model", default=None, choices=["full_view", "overlay"],
                    help="protocol family (only full_view is ported)")
    ap.add_argument("--topology", default=None,
                    choices=["uniform", "powerlaw"],
                    help="overlay exchange-degree family (overlay only)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.seed is not None:
        if args.seed >= 0:
            overrides["seed"] = args.seed
        else:
            import time as _t
            overrides["seed"] = int(_t.time())
    if args.peers is not None:
        overrides["max_nnb"] = args.peers
    if args.ticks is not None:
        overrides["total_ticks"] = args.ticks
    if args.model is not None:
        overrides["model"] = args.model
    if args.topology is not None:
        overrides["topology"] = args.topology
    try:
        cfg = SimConfig.from_conf(args.conf, **overrides)
    except (OSError, ValueError) as e:
        print(f"gossip_protocol_tpu_torch: {e}", file=sys.stderr)
        return 2

    from .core.sim import Simulation

    sim = Simulation(cfg, device=args.device)
    if args.bench:
        res = sim.run_bench()
        print(json.dumps({
            "n": cfg.n, "ticks": cfg.total_ticks, "device": args.device,
            "wall_s": round(res.wall_seconds, 6),
            "ticks_per_s": round(res.ticks_per_second, 1),
            "node_ticks_per_s": round(res.node_ticks_per_second, 1),
        }))
        return 0

    if not args.quiet:
        # parity with the reference's stdout (Application.cpp:146)
        for i in range(cfg.n):
            print(f"{i}-th introduced node is assigned with the address: "
                  f"{display_addr(i)}")

    res = sim.run()
    res.write_logs(args.outdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
