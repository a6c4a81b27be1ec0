"""The comparison that decides ``correct``: each sampled answer of the
window against the plain reference's run of the same configuration and
seed, value for value.

The configurations guarantee exactness, so the number compared is the
count of values that differ (limit 0), over every field of the answer:
a dense lane's final table, heartbeats, timestamps, in-flight gossip,
per-peer vectors and per-tick sent / received counters (and that every
row and column past the active corner stays zero); an overlay lane's
final view tables, per-peer vectors, send flags and per-tick metrics
(``live_uncovered`` aside: the fleet does not track it).
"""

from __future__ import annotations

import importlib

import torch


def reference(conf: dict):
    """The configuration's plain reference (``reference/<name>.py``)."""
    return importlib.import_module(f"benchmark.reference.{conf['reference']}")


def _diff(a, b) -> int:
    """Values that differ (every value, where the shapes do)."""
    b = torch.as_tensor(b)
    a = torch.as_tensor(a, device=b.device).to(torch.int64)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b.to(torch.int64)).sum())


def dense_mismatches(lane, ref: dict) -> int:
    a = ref["width"]
    fs = lane.final_state
    bad = 0
    for k in ("known", "hb", "ts", "gossip"):
        p = getattr(fs, k)
        bad += _diff(p[:a, :a], ref[k])
        bad += int((p[a:] != 0).sum()) + int((p[:a, a:] != 0).sum())
    for k in ("in_group", "own_hb", "joinreq", "joinrep"):
        v = getattr(fs, k)
        bad += _diff(v[:a], ref[k]) + int((v[a:] != 0).sum())
    for k in ("sent", "recv"):
        c = torch.as_tensor(getattr(lane, k))
        bad += _diff(c[:a], ref[k]) + int((c[a:] != 0).sum())
    return bad


def overlay_mismatches(lane, ref: dict) -> int:
    fs = lane.final_state
    bad = sum(_diff(getattr(fs, k), ref[k])
              for k in ("ids", "hb", "ts", "in_group", "own_hb",
                        "send_flags", "joinreq", "joinrep"))
    m = lane.metrics
    for j, name in enumerate(("in_group", "view_slots", "adds", "removals",
                              "false_removals", "victim_slots",
                              "live_uncovered", "sent", "recv")):
        if name != "live_uncovered":
            bad += _diff(getattr(m, name), ref["metrics"][:, j])
    return bad


def check(conf: dict, answers: list, device, control=None) -> dict:
    """Run the reference over each ``(seed, program lane)`` and count
    the values that differ."""
    ref_mod = reference(conf)
    compare = dense_mismatches if conf["reference"] == "dense" \
        else overlay_mismatches
    bad = 0
    for seed, lane in answers:
        ref = ref_mod.run_lane(conf, seed, device, control=control)
        bad += compare(lane, ref)
        del ref
    return dict(mismatched_values=bad, answers_checked=len(answers))
