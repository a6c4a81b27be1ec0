"""The knee of an open-loop cell: one set-up, then one window a rate, in
turn, through the cell's own driver, until a rate saturates (it
completes less than 0.9 of what it offers and its drain outlives the
arrivals by a fifth: :func:`benchmark.arrivals.saturated`).  The knee is
the highest rate the service sustains: it completes at least 0.9 of
what it offers and drains within a fifth of the arrivals' span.

    python3 -m benchmark.tools.knee --workload overlay65k-churn.served \\
        --seconds 20 --rates 8 10 12 14 16 18 [--seed 1]

prints a row a rate and a last JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from benchmark import spec
from benchmark.arrivals import (SATURATION_FRAC, SATURATION_SPAN_RATIO,
                                percentile, saturated)
from benchmark.harness import make_env
from benchmark.trace import NoTrace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    r = spec.resolve(spec.load_spec(), args.workload)
    env = make_env(r["config"], dict(r["traffic"]), args.seed,
                   torch.device("cuda"))
    driver = r["driver"]
    driver.setup(env)
    rows, knee = [], None
    for i, rate in enumerate(args.rates):
        env.traffic["rate_rps"] = rate
        env.seed = args.seed + i
        rec = driver.window(env, args.seconds, NoTrace())
        env.kept = []
        lat, lag = rec["latencies_s"], rec["lag_s"]
        span = args.seconds
        row = dict(offered_rps=rate, requests=rec["attempted"],
                   achieved_rps=rec["completed"] / rec["span_s"],
                   wall_s=rec["span_s"], p50_ms=percentile(lat, 50) * 1e3,
                   p95_ms=percentile(lat, 95) * 1e3,
                   lag_max_s=max(lag), lag_p95_s=percentile(lag, 95),
                   occupancy=rec["occupancy"], failed=rec["failed"])
        row["saturated"] = saturated(rate, row["achieved_rps"],
                                     rec["span_s"], span)
        row["sustained"] = row["achieved_rps"] >= SATURATION_FRAC * rate \
            and rec["span_s"] <= SATURATION_SPAN_RATIO * span
        rows.append(row)
        print(json.dumps(row), flush=True)
        if row["sustained"]:
            knee = rate
        if row["saturated"]:
            break
    print(json.dumps({"workload": args.workload, "knee_rps": knee,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
