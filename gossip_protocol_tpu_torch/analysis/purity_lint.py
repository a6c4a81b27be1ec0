"""AST purity lint: the port's source rules (counterpart of
``gossip_protocol_tpu/analysis/purity_lint.py``, retargeted at
``gossip_protocol_tpu_torch/``).

``no-wall-clock-in-pure-paths``
    The stochastic planes that must replay digest for digest —
    worlds.py, service/faults.py, service/traffic.py,
    models/scenarios.py, and the ring-order functions of
    service/scheduler.py — draw randomness only from a fresh
    ``numpy.random.default_rng((seed, idx, ...))`` keyed by a tuple,
    and never call ``time.*`` or mutable / unseeded RNG.  An injectable
    clock passed as a default parameter (``now=time.perf_counter``) is
    fine: the rule flags calls, not references.

``host-staging-is-numpy``
    The host-side functions — schedule builders, host lane stacking,
    checkpoint snapshot and stitch, the store's spill and journal —
    build no torch tensor (``torch.tensor``, ``torch.zeros``,
    ``torch.stack``, ...; the zero-copy ``torch.from_numpy`` is host
    work) and call no ``.to(`` or ``.cuda(``: a device tensor made
    there queues behind the in-flight fleet and serializes the
    pipelined scheduler.

``no-inplace-on-host-views``
    No slice / ellipsis writes into arrays aliased from result or
    metric attributes: a result's arrays may be ``.numpy()`` views of
    tensors or read-only views, and a write through one changes (or
    fails on) the result itself.  Writes into fresh locals are fine;
    writes through an attribute chain, or through a local bound by an
    aliasing converter (``np.asarray(lane.metrics.sent)``, ``.view()``,
    ``.reshape()``, ``.numpy()``), are flagged.

``journal-before-mutation``
    In service/scheduler.py and store/recovery.py every call that makes
    a request's terminal status visible (``._complete()`` /
    ``._fail()``) is textually dominated, within its function, by the
    matching write-ahead ``journal.outcome(...)`` append.

Every module and function these rules name must exist in the port: a
missing one is a finding (a renamed function would otherwise drop out
of the check unseen).  Findings can be allowlisted in
``analysis/lint_allow.toml``; every entry carries a ``why``, and an
entry without one is itself a finding.
"""

from __future__ import annotations

import ast
import os
import tomllib
from dataclasses import dataclass

from . import Finding
from ._astutil import REPO_ROOT, attr_chain as _attr_chain

PKG = "gossip_protocol_tpu_torch"

#: modules whose draws must be pure (seed, idx) functions
PURE_PATH_MODULES = (
    f"{PKG}/worlds.py",
    f"{PKG}/service/faults.py",
    f"{PKG}/service/traffic.py",
    f"{PKG}/models/scenarios.py",
)

#: (module, function) pairs whose bodies order the harvest of the
#: per-bucket in-flight rings: ring creation order and FIFO within a
#: ring stay a pure function of the submit / flush sequence.  The
#: scheduler reads the wall clock elsewhere (deadlines, queue-age
#: batching), so the rule is scoped to these functions.
RING_ORDER_FUNCS = {
    f"{PKG}/service/scheduler.py": (
        "_ring_key", "_inflight_batches", "_pop_oldest_inflight",
        "_abort_inflight", "resolve_inflight", "_harvest_ready"),
}

#: (module, function) pairs that are host-side by contract: schedule
#: builders, host lane stacking, checkpoint snapshot / stitch, the
#: store's spill and journal, the result digest on the resolve path
HOST_STAGING_FUNCS = {
    f"{PKG}/state.py": (
        "make_schedule_host", "slice_schedule", "pad_schedule_host"),
    f"{PKG}/models/overlay.py": (
        "make_overlay_schedule", "degree_thresholds"),
    f"{PKG}/core/fleet.py": (
        "stack_lanes_host", "_lane_state", "finish_lane",
        "_advance_checkpoints", "checkpoint_arrays",
        "checkpoint_from_arrays"),
    f"{PKG}/store/spill.py": (
        "_arrays_sha", "checkpoint_digest_from_arrays", "save_spill",
        "read_spill", "verify_spill", "inspect_spill", "_spill",
        "ref", "fetch", "materialize"),
    f"{PKG}/store/journal.py": (
        "_append", "meta", "submit", "cut", "fault", "outcome",
        "recover_mark", "read_journal"),
    f"{PKG}/store/recovery.py": (
        "recover_service",),
    f"{PKG}/service/replay.py": (
        "result_digest",),
}

#: modules checked for in-place writes on host views (the serving
#: layer's result handling, the fleet resolve paths and the store)
HOST_VIEW_MODULES = (
    f"{PKG}/service/faults.py",
    f"{PKG}/service/resilience.py",
    f"{PKG}/service/scheduler.py",
    f"{PKG}/service/replay.py",
    f"{PKG}/service/loadbench.py",
    f"{PKG}/core/fleet.py",
    f"{PKG}/core/sim.py",
    f"{PKG}/store/spill.py",
    f"{PKG}/store/journal.py",
    f"{PKG}/store/recovery.py",
    f"{PKG}/store/harness.py",
)

#: modules whose terminal-status writers must journal first
JOURNAL_ORDER_MODULES = (
    f"{PKG}/service/scheduler.py",
    f"{PKG}/store/recovery.py",
)

#: the handle methods that make a request's terminal status visible
#: to callers (service/types.py RequestHandle)
_TERMINAL_SETTERS = frozenset({"_complete", "_fail"})


#: converters that can ALIAS their argument (a write through the
#: result can mutate the argument's buffer); ``numpy`` is the tensor
#: method ``.numpy()``, which shares the tensor's memory
_ALIASING_CONVERTERS = frozenset({
    "asarray", "asanyarray", "ascontiguousarray", "view", "reshape",
    "ravel", "squeeze", "transpose", "atleast_1d", "atleast_2d", "numpy",
})

#: torch calls that make a tensor (on a device, or one that a later
#: ``.to`` would move): none belongs in a host staging function
_TORCH_CONSTRUCTORS = frozenset({
    "tensor", "as_tensor", "asarray", "zeros", "ones", "full", "empty",
    "arange", "linspace", "rand", "randn", "randint", "stack", "cat",
    "zeros_like", "ones_like", "full_like", "empty_like", "where",
    "from_dlpack",
})

#: tensor methods that move data to a device
_DEVICE_MOVES = frozenset({"to", "cuda"})


# ---- allowlist -------------------------------------------------------
@dataclass
class AllowEntry:
    rule: str
    file: str
    match: str   # substring of the offending source line
    why: str


def load_allowlist(path: str | None = None
                   ) -> tuple[list[AllowEntry], list[Finding]]:
    """The allowlist (``tomllib``) plus a finding for each malformed
    entry: one that lacks ``rule``, ``file``, ``match`` or ``why``, or
    whose ``why`` is empty, is itself a violation (every allowlisted
    finding is justified)."""
    path = path or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_allow.toml")
    where = "gossip_protocol_tpu_torch/analysis/lint_allow.toml"
    if not os.path.exists(path):
        return [], []
    try:
        with open(path, "rb") as f:
            doc = tomllib.load(f)
    except tomllib.TOMLDecodeError as e:
        return [], [Finding("allowlist", where, f"not valid TOML: {e}")]
    entries, findings = [], []
    for i, raw in enumerate(doc.get("allow", [])):
        keys = ("rule", "file", "match", "why")
        missing = [k for k in keys if not str(raw.get(k, "")).strip()]
        if missing:
            findings.append(Finding(
                "allowlist", where,
                f"entry {i} ({raw.get('rule')}, {raw.get('file')}, "
                f"{raw.get('match')!r}) lacks {missing} — every "
                "allowlisted finding must name its rule, file and line "
                "and say why"))
            continue
        entries.append(AllowEntry(**{k: str(raw[k]) for k in keys}))
    return entries, findings


def _allowed(entries, rule: str, relfile: str, src_line: str) -> bool:
    return any(e.rule == rule and e.file == relfile
               and e.match and e.match in src_line for e in entries)


# ---- shared AST helpers ----------------------------------------------
def _read_lines(path: str) -> tuple[ast.Module, list[str]]:
    with open(path) as f:
        src = f.read()
    return ast.parse(src, filename=path), src.splitlines()


def _is_region_write(sub: ast.Subscript) -> bool:
    """Slice / Ellipsis / tuple-containing-slice subscript — the
    numpy region-write shapes (``x[...]``, ``x[:, 1]``, ``x[a:b]``)."""
    sl = sub.slice
    if isinstance(sl, ast.Slice):
        return True
    if isinstance(sl, ast.Constant) and sl.value is Ellipsis:
        return True
    if isinstance(sl, ast.Tuple):
        return any(isinstance(e, ast.Slice)
                   or (isinstance(e, ast.Constant)
                       and e.value is Ellipsis)
                   for e in sl.elts)
    return False


# ---- rule: no-wall-clock-in-pure-paths -------------------------------
def _time_aliases(tree) -> tuple[set, set]:
    """(module aliases of ``time``, names imported FROM time) — so
    ``import time as t; t.sleep(...)`` and ``from time import
    perf_counter; perf_counter()`` are caught like the ``time.X()``
    attribute form."""
    mods, names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mods.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                names.add(a.asname or a.name)
    return mods, names


def _check_pure_paths(tree, lines, relfile, allow,
                      funcs=None) -> list[Finding]:
    """``funcs=None`` checks the whole module (the PURE_PATH_MODULES
    contract); a tuple of names scopes the rule to those function
    bodies (the RING_ORDER_FUNCS contract — modules that legitimately
    read wall clock elsewhere)."""
    out = []
    time_mods, time_names = _time_aliases(tree)
    if funcs is None:
        nodes = ast.walk(tree)
    else:
        nodes = (sub for node in ast.walk(tree)
                 if isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                 and node.name in funcs
                 for sub in ast.walk(node))
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        line = lines[node.lineno - 1] if node.lineno <= len(lines) \
            else ""
        where = f"{relfile}:{node.lineno}"

        def flag(detail):
            if not _allowed(allow, "no-wall-clock-in-pure-paths",
                            relfile, line):
                out.append(Finding("no-wall-clock-in-pure-paths",
                                   where, detail, path=line.strip()))

        if len(chain) == 2 and chain[0] in (time_mods | {"time"}):
            flag(f"call of time.{chain[1]} in a pure-replay path — "
                 "wall time must enter through an injectable clock "
                 "parameter, never a direct call")
        elif len(chain) == 1 and chain[0] in time_names:
            flag(f"call of {chain[0]} (imported from time) in a "
                 "pure-replay path — wall time must enter through an "
                 "injectable clock parameter, never a direct call")
        elif len(chain) >= 2 and chain[-2:-1] == ["random"] \
                and chain[0] in ("np", "numpy"):
            fn = chain[-1]
            if fn != "default_rng":
                flag(f"np.random.{fn} draws from MUTABLE global RNG "
                     "state — draw from a fresh "
                     "default_rng((seed, idx)) instead")
            elif not (node.args
                      and isinstance(node.args[0], ast.Tuple)):
                flag("default_rng() without a (seed, idx, ...) tuple "
                     "key — the draw is not a pure function of its "
                     "seed plane")
        elif chain == ["default_rng"]:
            if not (node.args and isinstance(node.args[0], ast.Tuple)):
                flag("default_rng() without a (seed, idx, ...) tuple "
                     "key — the draw is not a pure function of its "
                     "seed plane")
        elif chain[:1] == ["random"] and len(chain) == 2:
            flag(f"stdlib random.{chain[1]} call — mutable global "
                 "RNG in a replay path")
    return out


# ---- rule: host-staging-is-numpy -------------------------------------
def _check_host_staging(tree, lines, relfile, funcs, allow
                        ) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        if node.name not in funcs:
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) \
                    or not isinstance(sub.func, ast.Attribute):
                continue
            chain = _attr_chain(sub.func)
            bad = None
            if len(chain) == 2 and chain[0] == "torch" \
                    and chain[1] in _TORCH_CONSTRUCTORS:
                bad = ".".join(chain)
            elif sub.func.attr in _DEVICE_MOVES \
                    and chain[:1] not in (["np"], ["numpy"]):
                bad = f".{sub.func.attr}("
            if bad is None:
                continue
            line = lines[sub.lineno - 1] if sub.lineno <= len(lines) else ""
            if _allowed(allow, "host-staging-is-numpy", relfile, line):
                continue
            out.append(Finding(
                "host-staging-is-numpy", f"{relfile}:{sub.lineno}",
                f"{bad} inside {node.name}() — this function is host-side "
                "by contract: a tensor made or moved here queues behind "
                "the in-flight fleet and serializes the pipelined "
                "scheduler", path=node.name))
            break   # one finding per offending function is enough
    return out


def _missing_funcs(tree, relfile, funcs, rule) -> list[Finding]:
    """A finding for each named function the module does not define."""
    have = {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return [Finding(rule, relfile,
                    f"{name}() is named by the rule but not defined here — "
                    "a renamed function drops out of the check; update the "
                    "rule's list", path=name)
            for name in funcs if name not in have]


# ---- rule: no-inplace-on-host-views ----------------------------------
def _check_host_views(tree, lines, relfile, allow) -> list[Finding]:
    out = []

    _MODS = ("np", "numpy", "torch")

    def aliasing_binding(v, aliased) -> bool:
        """Does this RHS alias foreign (attribute-reached) memory?"""
        if isinstance(v, ast.Attribute) and _attr_chain(v):
            return True
        if not isinstance(v, ast.Call):
            return False
        c = _attr_chain(v.func)
        if not c or c[-1] not in _ALIASING_CONVERTERS:
            return False
        if c[0] in _MODS:
            # free-function converter: aliases iff an argument is an
            # attribute chain — np.asarray(lane.metrics.sent)
            return any(isinstance(a, ast.Attribute) and _attr_chain(a)
                       and _attr_chain(a)[0] not in _MODS
                       for a in v.args)
        # method-form converter (args or not): aliases iff the
        # receiver is itself an attribute chain —
        # lane.metrics.sent.reshape(2, 4) — or a local already known
        # to alias (m2 = m.view()); a bare safe local's method
        # (out.reshape(...)) stays clean
        return len(c) > 2 or (len(c) == 2 and c[0] in aliased)

    def visit(stmts, aliased: dict):
        """In-order statement walk; each function gets a fresh local
        alias map (a closure write-through is out of scope for this
        lint — the allowlist is the escape hatch)."""
        for node in stmts:
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                visit(node.body, {})
                continue
            if isinstance(node, ast.ClassDef):
                visit(node.body, {})
                continue
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in tgts:
                    if not (isinstance(tgt, ast.Subscript)
                            and _is_region_write(tgt)):
                        continue
                    base = tgt.value
                    hit = None
                    if isinstance(base, ast.Attribute) and \
                            _attr_chain(base) and \
                            _attr_chain(base)[0] not in (
                                "np", "numpy", "torch", "self"):
                        hit = ".".join(_attr_chain(base))
                    elif isinstance(base, ast.Name) \
                            and base.id in aliased:
                        hit = (f"{base.id} (aliased from an attribute"
                               f" at line {aliased[base.id]})")
                    if hit is None:
                        continue
                    line = lines[node.lineno - 1] \
                        if node.lineno <= len(lines) else ""
                    if _allowed(allow, "no-inplace-on-host-views",
                                relfile, line):
                        continue
                    out.append(Finding(
                        "no-inplace-on-host-views",
                        f"{relfile}:{node.lineno}",
                        f"region write into {hit} — a result's arrays "
                        "may be .numpy() views of its tensors or "
                        "read-only views; REPLACE the array "
                        "(.replace(field=new)) instead of writing "
                        "into it",
                        path=line.strip()))
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    if aliasing_binding(node.value, aliased):
                        aliased[name] = node.lineno
                    else:
                        aliased.pop(name, None)
            # recurse into compound statements with the same scope
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(node, attr, None)
                if sub and not isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                    visit(sub, aliased)
            for h in getattr(node, "handlers", []) or []:
                visit(h.body, aliased)
            for case in getattr(node, "cases", []) or []:
                visit(case.body, aliased)   # match statements

    visit(tree.body, {})
    return out


# ---- rule: journal-before-mutation -----------------------------------
def _walk_local(fn):
    """Walk a function's OWN statements, not those of nested defs —
    a setter inside a nested function must be judged against that
    function's journal appends, not the enclosing one's."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _check_journal_order(tree, lines, relfile, allow) -> list[Finding]:
    out = []
    fns = [n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    # a def nested inside another def is a DEFERRED body — textual
    # domination is meaningless there (the journal append lives at
    # the call site), so the rule only judges top-level fns/methods
    nested = {inner for fn in fns for inner in ast.walk(fn)
              if inner is not fn
              and isinstance(inner, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
    for fn in fns:
        if fn in nested:
            continue
        appends = []   # linenos of journal.outcome(...) appends
        setters = []   # (node, chain) of terminal-status calls
        for node in _walk_local(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if not chain:
                continue
            if chain[-1] == "outcome" and "journal" in chain[:-1]:
                appends.append(node.lineno)
            elif chain[-1] in _TERMINAL_SETTERS:
                setters.append((node, chain))
        for node, chain in setters:
            # textual domination within the function: the append must
            # come first on the path (same-line counts — the append
            # guard wraps the setter's own statement in practice)
            if any(jl <= node.lineno for jl in appends):
                continue
            line = lines[node.lineno - 1] \
                if node.lineno <= len(lines) else ""
            if _allowed(allow, "journal-before-mutation", relfile,
                        line):
                continue
            out.append(Finding(
                "journal-before-mutation",
                f"{relfile}:{node.lineno}",
                f".{chain[-1]}() makes a terminal status visible in "
                f"{fn.name}() with no preceding journal.outcome() "
                "append — a crash between the two re-runs (or loses) "
                "the request on recovery",
                path=fn.name))
    return out


# ---- the lint ---------------------------------------------------------
def lint(rules=None) -> list[Finding]:
    allow, findings = load_allowlist()

    def want(r):
        return rules is None or r in rules

    if want("no-wall-clock-in-pure-paths"):
        for rel in PURE_PATH_MODULES:
            tree, lines = _read_lines(os.path.join(REPO_ROOT, rel))
            findings += _check_pure_paths(tree, lines, rel, allow)
        for rel, funcs in RING_ORDER_FUNCS.items():
            tree, lines = _read_lines(os.path.join(REPO_ROOT, rel))
            findings += _missing_funcs(tree, rel, funcs,
                                       "no-wall-clock-in-pure-paths")
            findings += _check_pure_paths(tree, lines, rel, allow,
                                          funcs=funcs)
    if want("host-staging-is-numpy"):
        for rel, funcs in HOST_STAGING_FUNCS.items():
            tree, lines = _read_lines(os.path.join(REPO_ROOT, rel))
            findings += _missing_funcs(tree, rel, funcs,
                                       "host-staging-is-numpy")
            findings += _check_host_staging(tree, lines, rel, funcs,
                                            allow)
    if want("no-inplace-on-host-views"):
        for rel in HOST_VIEW_MODULES:
            tree, lines = _read_lines(os.path.join(REPO_ROOT, rel))
            findings += _check_host_views(tree, lines, rel, allow)
    if want("journal-before-mutation"):
        for rel in JOURNAL_ORDER_MODULES:
            tree, lines = _read_lines(os.path.join(REPO_ROOT, rel))
            findings += _check_journal_order(tree, lines, rel, allow)
    return findings


def raw_findings(rule: str, relfile: str) -> list[Finding]:
    """One rule over one repo file, allowlist IGNORED — the audit
    trail's other half: tests use this to prove every allowlist entry
    still masks a live finding (a stale entry hides nothing and must
    be dropped), whatever rule the entry belongs to."""
    tree, lines = _read_lines(os.path.join(REPO_ROOT, relfile))
    if rule == "no-wall-clock-in-pure-paths":
        return _check_pure_paths(tree, lines, relfile, [],
                                 funcs=RING_ORDER_FUNCS.get(relfile))
    if rule == "host-staging-is-numpy":
        return _check_host_staging(
            tree, lines, relfile, HOST_STAGING_FUNCS.get(relfile, ()),
            [])
    if rule == "no-inplace-on-host-views":
        return _check_host_views(tree, lines, relfile, [])
    if rule == "journal-before-mutation":
        return _check_journal_order(tree, lines, relfile, [])
    raise ValueError(f"unknown AST rule {rule!r}")


# ---- fixture entry points (used by tests/test_analysis.py) -----------
def lint_source(src: str, relfile: str = "<fixture>.py",
                rule: str = "no-wall-clock-in-pure-paths",
                staging_funcs=(), pure_funcs=None) -> list[Finding]:
    """Run ONE rule over an in-memory source string — the violation
    fixtures prove each rule actually fires without planting broken
    code in the tree.  ``pure_funcs`` scopes the no-wall-clock rule
    to named function bodies (the RING_ORDER_FUNCS form); None keeps
    the whole-module form."""
    tree = ast.parse(src)
    lines = src.splitlines()
    if rule == "no-wall-clock-in-pure-paths":
        return _check_pure_paths(tree, lines, relfile, [],
                                 funcs=pure_funcs)
    if rule == "host-staging-is-numpy":
        return _check_host_staging(tree, lines, relfile,
                                   tuple(staging_funcs), [])
    if rule == "no-inplace-on-host-views":
        return _check_host_views(tree, lines, relfile, [])
    if rule == "journal-before-mutation":
        return _check_journal_order(tree, lines, relfile, [])
    raise ValueError(f"unknown AST rule {rule!r}")
