"""One run of one cell: set-up, the measured (or traced) window, the
check against the plain reference, and the result line.

The order matters: the window closes; the device's memory peak is read;
the traffic driver hands over the sampled answers and drops everything of
the program; only then does the reference run, lane by lane, so it
never sets the peak.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import spec as specmod
from benchmark.check import check
from benchmark.trace import NoTrace, Trace

#: top-level module names no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "gossip_protocol_tpu")


class TraceIncomplete(RuntimeError):
    """A traced window whose device kernel events do not match its
    launch calls: the profiler lost events, so its device times, and
    every share read from them, would read wrong."""


def process_start_s() -> float:
    """The process's start on the wall clock (from /proc), so set-up
    counts the interpreter's own start; the harness's import time where
    /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _sim_config(conf: dict):
    from gossip_protocol_tpu_torch.config import SimConfig
    names = {f.name for f in dataclasses.fields(SimConfig)}
    return SimConfig(**{k: v for k, v in conf.items() if k in names})


def make_env(conf: dict, traffic: dict, seed: int, dev) -> SimpleNamespace:
    """What a traffic driver is handed: the configuration (as run and as
    the port's ``SimConfig``), the mix, the seed's generators (``rng``
    for the traffic, ``pick`` for the answers kept) and the device."""
    import torch
    return SimpleNamespace(
        cfg=_sim_config(conf), conf=conf, traffic=traffic, seed=int(seed),
        device=dev, rng=np.random.default_rng((int(seed), 10)),
        pick=np.random.default_rng((int(seed), 11)), kept=None,
        sync=(lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
        else (lambda: None))


def check_trace(tr: dict) -> None:
    """Refuse a trace that lost device events (:class:`TraceIncomplete`)."""
    if tr["kernels"] != tr["launches"]:
        raise TraceIncomplete(
            f"the trace holds {tr['kernels']} kernel events for "
            f"{tr['launches']} launch calls")


def _builds() -> tuple[int, int]:
    """The program's build counters: nvcc compilations, run programs."""
    from gossip_protocol_tpu_torch.core.tick import run_build_count
    from gossip_protocol_tpu_torch.ops.cuda._build import nvcc_build_count
    return nvcc_build_count(), run_build_count()


def _card(device) -> dict:
    import torch
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
               count=1)
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i",
                            str(device.index or 0)], capture_output=True,
                           text=True, timeout=20)
        out["power_limit_w"] = float(q.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", repo: Path = specmod.REPO,
             log=None, conf_over: dict | None = None,
             traffic_over: dict | None = None) -> dict:
    """The result of one run (the last line's object).  ``conf_over`` and
    ``traffic_over`` shrink a cell for the CPU tests; a run from the
    command line takes neither."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = process_start_s()
    spec = specmod.load_spec(repo / "BENCHMARK.json")
    r = specmod.resolve(spec, cell, repo)
    conf = {**r["config"], **(conf_over or {})}
    traffic = {**r["traffic"], **(traffic_over or {})}
    driver = r["driver"]
    dev = torch.device(device)
    env = make_env(conf, traffic, seed, dev)
    card = _card(dev)
    driver.setup(env)
    tracer = Trace() if trace else NoTrace()
    if trace:
        tracer.start()
        driver.lead_in(env)
        seconds = min(seconds, traffic.get("trace_seconds") or seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t_start
    builds0 = _builds()
    record = driver.window(env, seconds, tracer)
    builds = [b - a for a, b in zip(builds0, _builds())]
    log(f"builds in the window: {builds[0]} nvcc, {builds[1]} run programs")
    tr = None
    if trace:
        tracer.stop()
        tr = tracer.reduce()
        log(f"trace: {tr['kernels']} kernel events, {tr['launches']} launch "
            f"calls, busy {tr['busy_s']:.4f} s of {tr['window_s']:.4f} s")
        check_trace(tr)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    answers = driver.answers(env, record)
    driver.release(env)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    chk = check(conf, answers, dev)
    answers = None
    log(f"set-up {setup_s:.3f} s, window {record['span_s']:.3f} s, "
        f"reference check {time.perf_counter() - t_chk:.3f} s")
    if "lag_s" in record and record["lag_s"]:
        lag = np.asarray(record["lag_s"])
        log(f"generator lateness: max {lag.max():.6f} s, p95 "
            f"{np.percentile(lag, 95):.6f} s over {lag.size} arrivals")
    ctx = dict(conf=conf, traffic=traffic, record=record, trace=tr,
               setup_s=setup_s, workload=r["workload"])
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, (entry, mod) in r["metrics"].items():
        if not any(m is entry for m in spec[group]):
            continue
        v = mod.read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": entry["unit"]}
    checks = {
        "mismatched_values": {"value": chk["mismatched_values"], "limit": 0},
        "unanswered": {"value": record["failed"], "limit": 0},
        "answers_checked": {"value": chk["answers_checked"], "at_least": 1}}
    correct = (chk["mismatched_values"] == 0 and record["failed"] == 0
               and chk["answers_checked"] >= 1)
    out = dict(correct=correct, attempted=record["attempted"],
               failed=record["failed"], metrics=metrics,
               device=dict(card, memory_peak_bytes=peak))
    if tr is not None:
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = dict(device_ops=tr["device_ops"],
                                idle_gaps=tr["idle_gaps"])
    out["checks"] = checks
    for k, c in checks.items():
        rel = ">=" if "at_least" in c else "<="
        log(f"check {k} {c['value']} {rel} "
            f"{c.get('limit', c.get('at_least'))}")
    return out
