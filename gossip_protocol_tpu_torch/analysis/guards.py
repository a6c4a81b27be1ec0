"""Runtime guards: the rebuild and transfer invariants, enforced live
(counterpart of ``gossip_protocol_tpu/analysis/guards.py``).

* **No rebuild in a steady-state lap.**  The JAX package counts XLA
  compiles; the port builds two things: fleet runs (the misses of the
  fleet program cache, ``core/tick.py run_build_count``) and kernel
  libraries (one nvcc a source, ``ops/cuda/_build.py
  nvcc_build_count``).  :func:`build_budget` raises
  :class:`RebuildBudget` when a block adds more than its budget of
  either, and :func:`steady_state_build_gate` runs a warmed fleet lap
  under a zero budget: a build there means a cache key regressed or a
  shape leaked.
* **No implicit transfer in a launched fleet's wait and resolve.**
  :func:`no_implicit_transfers` is ``torch.cuda.set_sync_debug_mode(
  "error")``: a synchronizing copy or call raises.  The fleet's results
  cross to the host by non-blocking copies into pinned memory started at
  launch, so its wait and resolve need none.  The mode does nothing on
  the CPU, so the gate runs only on a card, and :func:`self_check`
  leaves the rule out on the CPU (``unchecked_rules``).

Every gate runs on the card unless the caller asks for ``cpu``.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from . import Finding


class RebuildBudget(RuntimeError):
    """A guarded block built more fleet runs or kernels than its budget."""


class BuildCounter:
    """Fleet-run builds and nvcc compilations since the counter started."""

    def __init__(self):
        from ..core.tick import run_build_count
        from ..ops.cuda._build import nvcc_build_count
        self._runs, self._nvcc = run_build_count, nvcc_build_count
        self.runs0, self.nvcc0 = run_build_count(), nvcc_build_count()

    @property
    def runs(self) -> int:
        return self._runs() - self.runs0

    @property
    def nvcc(self) -> int:
        return self._nvcc() - self.nvcc0

    @property
    def count(self) -> int:
        return self.runs + self.nvcc


@contextmanager
def build_budget(max_builds: int = 0, what: str = "guarded block"):
    """Raise :class:`RebuildBudget` when the block adds more than
    ``max_builds`` fleet-run builds plus nvcc compilations (0: a warm
    path must stay warm)."""
    counter = BuildCounter()
    yield counter
    if counter.count > max_builds:
        raise RebuildBudget(
            f"{what}: {counter.runs} fleet run build(s) and {counter.nvcc} "
            f"nvcc compilation(s) against a budget of {max_builds} — a "
            "steady-state build means a cache key regressed or a shape "
            "leaked (no-recompile-steady-state)")


@contextmanager
def no_implicit_transfers(device="cuda"):
    """``set_sync_debug_mode("error")`` for the block on a card (a
    synchronizing transfer raises); nothing on the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _gate_cfg():
    from ..config import SimConfig
    return SimConfig(model="overlay", max_nnb=64, total_ticks=48,
                     churn_rate=0.2, rejoin_after=None, seed=11,
                     step_rate=8.0 / 64)


def steady_state_build_gate(device=None, inject_rebuild: bool = False
                            ) -> dict:
    """A warmed fleet lap under a zero build budget.

    Runs the small overlay fleet once (the warm lap: builds its run and,
    on a card, the kernels), then two more laps at other seeds, which
    must ride the same run (the cache keys the config's shape; seeds are
    schedule data) under a zero budget.  ``inject_rebuild=True`` evicts
    the run inside the guarded laps, so the next lap builds it again, to
    show the gate trips.  Returns ``{"ok", "runs", "nvcc"[, "detail"]}``.
    """
    from ..core.fleet import FleetSimulation
    from ..state import resolve_device
    device = resolve_device(device)
    cfg = _gate_cfg()
    FleetSimulation(cfg, device=device).run(seeds=[11, 12], warmup=False)
    c = None
    try:
        with build_budget(0, what="steady-state fleet lap") as c:
            FleetSimulation(cfg, device=device).run(seeds=[13, 14],
                                                    warmup=False)
            sim = FleetSimulation(cfg, device=device)
            sim.run(seeds=[15, 16], warmup=False)
            if inject_rebuild:
                sim.evict_programs()
                sim.run(seeds=[17, 18], warmup=False)
    except RebuildBudget as e:
        return {"ok": False, "runs": c.runs, "nvcc": c.nvcc,
                "detail": str(e)}
    return {"ok": True, "runs": c.runs, "nvcc": c.nvcc}


def resolve_transfer_gate(device=None, inject_transfer: bool = False
                          ) -> dict:
    """A dense bench fleet launched, then waited for and resolved under
    :func:`no_implicit_transfers`; ``inject_transfer=True`` reads a
    device value to the host inside the guarded block to show the guard
    bites.  Runs only on a card: on the CPU the guard checks nothing, so
    the gate raises ``ValueError``.  Returns ``{"ok"[, "detail"]}``."""
    from ..config import SimConfig
    from ..core.fleet import FleetSimulation
    from ..state import resolve_device
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(
            "resolve_transfer_gate checks set_sync_debug_mode, which acts "
            f"only on a card; {device} cannot check "
            "no-implicit-transfer-in-resolve")
    cfg = SimConfig(max_nnb=64, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0, total_ticks=80)
    sim = FleetSimulation(cfg, device=device)
    sim.run_bench(seeds=[1, 2])                    # warm: builds, pinning
    pending = sim.launch_bench(seeds=[1, 2], warmup=False)
    probe = torch.ones(1, device=device)
    try:
        with no_implicit_transfers(device):
            pending.wait()
            pending.resolve()
            if inject_transfer:
                float(probe.sum())
    except RuntimeError as e:
        return {"ok": False, "detail": str(e).splitlines()[0]}
    return {"ok": True}


def self_check(rules=None, device=None) -> list[Finding]:
    """The guard pass: both gates on ``device`` (the card unless the
    caller asks for ``cpu``), clean, and each with its violation
    injected, which must trip.  On the CPU the transfer gate is left out
    (``unchecked_rules``): the sync-debug mode acts only on a card."""
    from . import unchecked_rules
    from ..state import resolve_device
    device = resolve_device(device)
    skip = unchecked_rules(device)
    findings = []

    def want(r):
        return (rules is None or r in rules) and r not in skip

    if want("no-recompile-steady-state"):
        res = steady_state_build_gate(device)
        if not res["ok"]:
            findings.append(Finding(
                "no-recompile-steady-state", "guards.steady_state_build_gate",
                res["detail"]))
        if steady_state_build_gate(device, inject_rebuild=True)["ok"]:
            findings.append(Finding(
                "no-recompile-steady-state", "guards.self_check",
                "an evicted run rebuilt inside the guarded lap did not "
                "trip the zero budget — the gate is blind"))
    if want("no-implicit-transfer-in-resolve"):
        res = resolve_transfer_gate(device)
        if not res["ok"]:
            findings.append(Finding(
                "no-implicit-transfer-in-resolve",
                "guards.resolve_transfer_gate",
                f"a launched fleet's wait and resolve synchronized: "
                f"{res['detail']}"))
        if resolve_transfer_gate(device, inject_transfer=True)["ok"]:
            findings.append(Finding(
                "no-implicit-transfer-in-resolve", "guards.self_check",
                "a device-to-host read under the guard did not raise — "
                "the sync-debug mode is inert on this card"))
    return findings
