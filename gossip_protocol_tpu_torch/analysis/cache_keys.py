"""Cache-key completeness: every config field a cached builder reads is
part of its program-cache / bucket key, or flows through the schedule
as data (counterpart of ``gossip_protocol_tpu/analysis/cache_keys.py``,
over the port's builders and keys).

The stale-program bug class: the fleet program cache
(``core/fleet.py _FLEET_FN_CACHE``, keyed by ``fleet_shape_key`` with
``models/segments.py plan_signature`` and ``SimConfig.worlds_key``) and
the serving layer's buckets (``service/bucket.py bucket_key``) hand one
built run to every config whose key matches.  A field that a builder
reads but no key folds in lets two configs that differ only in that
field share one run: wrong results, no error.  The sound set is::

    fields_read(builders)  ⊆  fields_read(key functions)
                              ∪ fields_read(schedule builders)

because what the schedule builders read reaches the run as per-call
data.  The overlay keys the whole config (``fleet_shape_key`` keys
``cfg.replace(seed=0)``), which this pass pins structurally.  The
canonical tier (``service/canonical.py``) is held the same way against
its own keys: the ladder rung, ``quantized_plan_signature`` and
``worlds.py canonical_world_key``.

Every module and function named here must exist in the port: a
missing one is a finding.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from . import Finding
from ._astutil import REPO_ROOT, attr_chain
from ..config import SimConfig

SIM_FIELDS = frozenset(f.name for f in dataclasses.fields(SimConfig))

#: property aliases that read like fields in the scanned source
#: (``cfg.n`` IS ``cfg.max_nnb``, config.py)
FIELD_ALIASES = {"n": "max_nnb"}

#: names a SimConfig rides under in the scanned functions
CFG_ROOTS = frozenset({"cfg", "c", "c0", "cw", "cfg_w", "gcfg",
                       "lane_cfg", "fleet_cfg", "dcfg", "ocfg"})

PKG = "gossip_protocol_tpu_torch"

#: functions whose reads shape a run that a cache hands out
BUILDER_FUNCS = {
    f"{PKG}/core/tick.py": (
        "make_run", "make_tick", "make_tick_run", "make_fleet_tick"),
    f"{PKG}/core/dense_corner.py": (
        "make_corner_run", "active_bound", "bench_stream_width"),
    f"{PKG}/core/dense_mega.py": (
        "dense_mega_supported", "make_dense_mega_run"),
    f"{PKG}/core/fleet.py": (
        "_shared_drop", "fleet_shape_key", "_dense_fn", "launch",
        "launch_bench", "launch_leg", "_overlay_launch",
        "_overlay_leg_launch", "_dense_trace_launch", "_overlay_fleet_fn",
        "_lane_cfgs", "_stage_dense", "_dense_trace_lanes"),
    f"{PKG}/models/overlay.py": (
        "make_overlay_run", "make_overlay_tick", "make_overlay_fleet_run",
        "build_overlay_fleet_run", "tick_flags", "world_flags"),
    f"{PKG}/models/overlay_grid.py": (
        "make_grid_run", "make_grid_fleet_run", "grid_supported",
        "grid_kernel_kwargs"),
    f"{PKG}/models/overlay_mega.py": (
        "mega_supported", "make_mega_run", "mega_kernel_kwargs"),
}

#: functions whose reads form the cache / bucket keys
KEY_FUNCS = {
    f"{PKG}/core/fleet.py": ("fleet_shape_key",),
    f"{PKG}/models/segments.py": (
        "plan_signature", "phase_windows", "step_fraction",
        "checkpoint_ticks"),
    f"{PKG}/config.py": ("worlds_key",),
    f"{PKG}/service/bucket.py": ("bucket_key",),
    f"{PKG}/core/dense_corner.py": ("active_bound",),
}

#: the canonical key tier (service/canonical.py): the pad-ladder rung
#: over n, the quantized plan signature and the world split.  Kept
#: apart from KEY_FUNCS: a field only the canonical key reads does not
#: count as covered for the exact buckets.
CANON_KEY_FUNCS = {
    f"{PKG}/service/canonical.py": (
        "canonical_bucket_key", "canonical_fleet_shape_key",
        "canonical_supported", "ladder_rung"),
    f"{PKG}/models/segments.py": (
        "quantized_plan_signature", "quantize_tick"),
    f"{PKG}/worlds.py": ("canonical_world_key",),
}

#: what a canonical run builds on: the shared tick builder plus the
#: canonical fleet's own staging
CANON_BUILDER_FUNCS = {
    f"{PKG}/core/tick.py": ("make_tick", "make_fleet_tick"),
    f"{PKG}/core/fleet.py": ("_stage_dense", "_dense_trace_lanes"),
}

#: functions whose reads flow through the schedule as data
DATA_FUNCS = {
    f"{PKG}/state.py": (
        "make_schedule_host", "make_schedule", "init_state",
        "slice_schedule", "pad_schedule_host"),
    f"{PKG}/models/overlay.py": (
        "make_overlay_schedule", "resolved_dims", "degree_thresholds",
        "init_overlay_state"),
    f"{PKG}/config.py": ("start_tick",),
}

#: every function in worlds.py builds schedule data (the hashed node
#: assignments are seed data; the windows are also folded into
#: plan_signature through phase_windows)
DATA_MODULES = (f"{PKG}/worlds.py",)


def _collect_reads(nodes, relfile, roots=CFG_ROOTS,
                   self_cfg=True) -> dict:
    """``{field: [file:line, ...]}`` of SimConfig attribute reads on
    the given roots (plus ``self.<root>`` chains and bare ``self``
    for config methods)."""
    reads: dict = {}
    for node in nodes:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Attribute):
                continue
            chain = attr_chain(sub)
            if chain:
                chain[-1] = FIELD_ALIASES.get(chain[-1], chain[-1])
            if not chain or chain[-1] not in SIM_FIELDS:
                continue
            root_ok = (chain[0] in roots
                       or (self_cfg and len(chain) >= 2
                           and chain[0] == "self"
                           and (chain[1] in roots
                                or len(chain) == 2)))
            if not root_ok:
                continue
            reads.setdefault(chain[-1], []).append(
                f"{relfile}:{sub.lineno}")
    return reads


def _find_funcs(tree, names):
    found = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in names:
            found.append(node)
    return found


def fields_read(spec: dict, whole_modules=()) -> dict:
    """Union the per-function reads over a {relfile: (funcs,)} spec."""
    reads: dict = {}
    for relfile, funcs in spec.items():
        path = os.path.join(REPO_ROOT, relfile)
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        nodes = _find_funcs(tree, set(funcs))
        for fld, locs in _collect_reads(nodes, relfile).items():
            reads.setdefault(fld, []).extend(locs)
    for relfile in whole_modules:
        path = os.path.join(REPO_ROOT, relfile)
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for fld, locs in _collect_reads([tree], relfile).items():
            reads.setdefault(fld, []).extend(locs)
    return reads


def fields_read_source(src: str, funcs, relfile="<fixture>.py") -> dict:
    """Fixture entry: reads of an in-memory builder source."""
    tree = ast.parse(src)
    return _collect_reads(_find_funcs(tree, set(funcs)), relfile)


def overlay_bakes_whole_config() -> bool:
    """Structural pin: ``fleet_shape_key``'s overlay branch must still
    key the ENTIRE config (``cfg.replace(seed=0)``) — the one line
    that makes every overlay builder read key-covered."""
    path = os.path.join(REPO_ROOT, f"{PKG}/core/fleet.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for fn in _find_funcs(tree, {"fleet_shape_key"}):
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) \
                    and attr_chain(sub.func)[-1:] == ["replace"] \
                    and [k.arg for k in sub.keywords] == ["seed"]:
                return True
    return False


def builder_fields() -> dict:
    return fields_read(BUILDER_FUNCS)


def covered_fields() -> set:
    covered = set(fields_read(KEY_FUNCS))
    covered |= set(fields_read(DATA_FUNCS, whole_modules=DATA_MODULES))
    # ``seed`` never keys anything by design: it flows through the
    # Schedule arrays / per-lane PRNG keys on every path
    covered.add("seed")
    return covered


def canonical_builder_fields() -> dict:
    return fields_read(CANON_BUILDER_FUNCS)


def canonical_covered_fields() -> set:
    """Fields safe under the canonical equivalence-class key: folded
    into the canonical key itself (which reads the ladder rung, the
    quantized signature, and the world split), or riding the padded
    Schedule arrays / world planes as per-request DATA — exact
    windows, drop realizations, and runtime world operands all travel
    that second way by design."""
    covered = set(fields_read(CANON_KEY_FUNCS))
    covered |= set(fields_read(DATA_FUNCS, whole_modules=DATA_MODULES))
    covered.add("seed")
    return covered


def canonical_missing_fields(builders: dict | None = None,
                             covered: set | None = None) -> dict:
    """``{field: [builder locations]}`` read by the canonical-path
    builders but neither canonical-key-folded nor schedule data."""
    builders = canonical_builder_fields() if builders is None else builders
    covered = canonical_covered_fields() if covered is None else covered
    return {f: locs for f, locs in sorted(builders.items())
            if f not in covered}


def missing_fields(builders: dict | None = None,
                   covered: set | None = None) -> dict:
    """``{field: [builder locations]}`` read by builders but neither
    key-folded nor schedule data."""
    builders = builder_fields() if builders is None else builders
    covered = covered_fields() if covered is None else covered
    return {f: locs for f, locs in sorted(builders.items())
            if f not in covered}


def missing_functions(spec: dict) -> list[tuple[str, str]]:
    """``(file, function)`` of each function a spec names that its
    module does not define."""
    out = []
    for relfile, funcs in spec.items():
        path = os.path.join(REPO_ROOT, relfile)
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        have = {n.name for n in _find_funcs(tree, set(funcs))}
        out += [(relfile, fn) for fn in funcs if fn not in have]
    return out


def check() -> list[Finding]:
    findings = []
    for rule, specs in (
            ("cache-key-complete", (BUILDER_FUNCS, KEY_FUNCS, DATA_FUNCS)),
            ("canon-key-complete", (CANON_BUILDER_FUNCS, CANON_KEY_FUNCS))):
        for spec in specs:
            for relfile, fn in missing_functions(spec):
                findings.append(Finding(
                    rule, relfile, f"{fn}() is named by the key scan but "
                    "not defined here — a renamed builder or key drops "
                    "out of the check; update the scan's lists", path=fn))
    if not overlay_bakes_whole_config():
        findings.append(Finding(
            "cache-key-complete",
            f"{PKG}/core/fleet.py:fleet_shape_key",
            "the overlay branch no longer bakes cfg.replace(seed=0) "
            "— every overlay builder read just lost its key "
            "coverage; restore the whole-config key or enumerate "
            "the overlay fields explicitly"))
    for fld, locs in missing_fields().items():
        findings.append(Finding(
            "cache-key-complete", locs[0],
            f"SimConfig.{fld} is read by a cached builder but folded "
            "into NO cache key (fleet_shape_key / plan_signature / "
            "worlds_key / bucket_key) and is not schedule data — two "
            f"configs differing only in {fld!r} can be served one "
            f"stale program (all readers: {', '.join(sorted(set(locs)))})"))
    for fld, locs in canonical_missing_fields().items():
        findings.append(Finding(
            "canon-key-complete", locs[0],
            f"SimConfig.{fld} is read by a canonical-path builder but "
            "folded into NO canonical key component "
            "(canonical_fleet_shape_key / quantized_plan_signature / "
            "canonical_world_key) and is not schedule data — two "
            f"requests differing only in {fld!r} can land in one "
            "equivalence class and share one stale canonical program "
            f"(all readers: {', '.join(sorted(set(locs)))})"))
    return findings
