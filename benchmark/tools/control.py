"""The control of a configuration's check: the plain reference put in the
program's place with the configuration's guarantee broken (the dense
merge's payloads rounded through bfloat16, the overlay's priority keys
compared in float32), judged by the benchmark's own comparison
(:func:`benchmark.check.check`) against the exact reference.

    python3 -m benchmark.tools.control --config dense4096-drop \\
        --seeds 11 12 13 [--device cuda]

prints one line a seed (the count, whether the check reads it correct,
the seconds each side took) and a last JSON line.  The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

from benchmark import spec
from benchmark.check import check, reference
from benchmark.reference.overlay import METRICS

#: the control of each reference
CONTROLS = {"dense": "bf16", "overlay": "f32_key"}
#: the fields of a lane's final state each reference returns
STATE = {"dense": ("known", "hb", "ts", "gossip", "in_group", "own_hb",
                   "joinreq", "joinrep"),
         "overlay": ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
                     "joinreq", "joinrep")}


def as_lane(conf: dict, res: dict) -> SimpleNamespace:
    """A reference's result in the shape of a program lane, so the
    check reads it as it reads the program's."""
    kind = conf["reference"]
    lane = SimpleNamespace(final_state=SimpleNamespace(
        **{k: res[k] for k in STATE[kind]}))
    if kind == "dense":
        lane.sent, lane.recv = res["sent"], res["recv"]
    else:
        lane.metrics = SimpleNamespace(
            **{k: res["metrics"][:, j] for j, k in enumerate(METRICS)})
    return lane


def readings(conf: dict, seeds, device) -> list[dict]:
    ctl = CONTROLS[conf["reference"]]
    ref = reference(conf)
    out = []
    for s in seeds:
        t0 = time.perf_counter()
        low = as_lane(conf, ref.run_lane(conf, int(s), device, control=ctl))
        t1 = time.perf_counter()
        chk = check(conf, [(int(s), low)], device)
        t2 = time.perf_counter()
        out.append(dict(seed=int(s), control=ctl,
                        mismatched_values=chk["mismatched_values"],
                        correct=chk["mismatched_values"] == 0,
                        control_s=t1 - t0, reference_s=t2 - t1))
        del low
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    entry = spec.find(spec.load_spec()["configs"], args.config, "config")
    conf = spec.read_json(spec.REPO / entry["file"])
    rows = readings(conf, args.seeds, torch.device(args.device))
    for r in rows:
        print(f"control {args.config} seed {r['seed']}: {r['control']} "
              f"differs in {r['mismatched_values']} values, correct "
              f"{r['correct']} (control {r['control_s']:.2f} s, check "
              f"{r['reference_s']:.2f} s)", flush=True)
    print(json.dumps({"config": args.config, "readings": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
