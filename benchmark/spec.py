"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* a configuration ``<config>``: ``configs/<config>.json``;
* a traffic mix ``<traffic>``: ``traffic/<traffic>.json``, whose
  ``driver`` names ``drivers/<driver>.py``;
* a metric ``<name>`` (end-to-end or per-layer): ``metrics/<name>.py``,
  whose ``read(ctx)`` returns the number or None.

So a later cell, mix or metric is a new file and a new entry, never an
edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_spec(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file path (metric and driver files carry dots
    in their names, so they are not imported as packages)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, cell: str, group: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, and those without that key."""
    return [m for m in spec[group]
            if "workloads" not in m or cell in m["workloads"]]


def resolve(spec: dict, cell: str, repo: Path = REPO) -> dict:
    """Everything one cell needs, by name: its entry, its configuration
    (the file's contents), its traffic mix, its driver module and its
    metric modules (``repo``: the checkout's root)."""
    root = repo / ROOT.name
    wl = find(spec["workloads"], cell, "workload")
    conf_entry = find(spec["configs"], wl["config"], "config")
    conf = read_json(repo / conf_entry["file"])
    traffic = read_json(root / "traffic" / f"{wl['traffic']}.json")
    driver = load_module(root / "drivers" / f"{traffic['driver']}.py",
                         "driver." + traffic["driver"])
    metrics = {}
    for group in ("end_to_end", "per_layer"):
        for m in metrics_of(spec, cell, group):
            metrics[m["name"]] = (m, load_module(
                root / "metrics" / f"{m['name']}.py", m["name"]))
    return dict(workload=wl, config_entry=conf_entry, config=conf,
                traffic=traffic, driver=driver, metrics=metrics)
