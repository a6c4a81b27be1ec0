"""Multi-device dry run on a mesh of one process (the port's counterpart
of ``__graft_entry__.py dryrun_multichip``).

:func:`dryrun_multichip` runs one sharded dense tick and one sharded
overlay tick over an n-entry mesh at tiny shapes (``cuda`` unless
``device="cpu"``; on one card the entries repeat it) and holds each
against the single-device tick: every table, counter and metric.

    python -m gossip_protocol_tpu_torch.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from .config import SimConfig


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Raises unless the sharded ticks equal the single-device ones."""
    from .core.tick import make_tick_run
    from .models.overlay import (init_overlay_state, make_overlay_run,
                                 make_overlay_schedule)
    from .models.overlay_sharded import (make_overlay_mesh,
                                         make_sharded_overlay_run,
                                         shard_overlay_state)
    from .parallel.sharded import make_mesh, make_sharded_run, shard_state
    from .state import init_state, make_schedule

    # at least 16 peers, a multiple of the entry count
    n_peers = -(-max(4 * n_devices, 16) // n_devices) * n_devices
    cfg = SimConfig(max_nnb=n_peers, single_failure=True, drop_msg=True,
                    msg_drop_prob=0.1, seed=0, total_ticks=1)
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.devices.flat[0]
    sched = make_schedule(cfg, device=dev)
    final, ev = make_sharded_run(cfg, mesh)(
        shard_state(init_state(cfg, device=dev), mesh), sched)
    ref, rev = make_tick_run(cfg)(init_state(cfg, device=dev), sched)
    if final.tick != 1:
        raise AssertionError(f"sharded dense run stopped at {final.tick}")
    for f in ("known", "hb", "ts", "gossip", "in_group", "own_hb"):
        if not torch.equal(getattr(final, f), getattr(ref, f)):
            raise AssertionError(f"sharded dense tick: {f} differs")
    for f in ("added", "removed", "sent", "recv"):
        if not torch.equal(getattr(ev, f), getattr(rev, f)):
            raise AssertionError(f"sharded dense tick: {f} differs")

    p = 1 << (n_devices.bit_length() - 1)       # a power of two <= n
    ocfg = SimConfig(model="overlay", max_nnb=max(8 * p, 64), seed=0,
                     total_ticks=2, single_failure=True, drop_msg=False,
                     fail_tick=1, step_rate=1.0)
    omesh = make_overlay_mesh(p, device=device)
    osched = make_overlay_schedule(ocfg)
    ostate = init_overlay_state(ocfg, dev)
    ofinal, omet = make_sharded_overlay_run(ocfg, omesh)(
        shard_overlay_state(ostate, omesh), osched)
    oref, oref_met = make_overlay_run(ocfg, mega=False, grid=False)(
        ostate, osched)
    for f in ("ids", "hb", "ts", "send_flags", "in_group", "own_hb"):
        if not torch.equal(getattr(ofinal, f), getattr(oref, f)):
            raise AssertionError(f"sharded overlay tick: {f} differs")
    if not torch.equal(omet.recv, oref_met.recv):
        raise AssertionError("sharded overlay tick: metrics differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
