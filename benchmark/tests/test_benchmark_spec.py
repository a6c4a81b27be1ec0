"""BENCHMARK.json against the contract's form, and the harness's data:
every name resolves to its files, and a new configuration, mix and metric
are picked up from files alone."""

import json
import math
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

S = spec.load_spec()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(S) == TOP
    assert 1 <= len(S["paths"]) <= 16 and S["paths"] == ["benchmark"]
    assert len(S["command"]) <= 32
    assert all(LINE.match(w) for w in S["command"])
    assert isinstance(S["run_seconds"], int) and 1 <= S["run_seconds"] <= 51
    assert len((spec.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(S["configs"]) <= 24 and 1 <= len(S["workloads"]) <= 24
    assert 1 <= len(S["end_to_end"]) <= 16
    assert 1 <= len(S["per_layer"]) <= 128


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})])
def test_entries_keys_and_names(group, keys):
    names = [e["name"] for e in S[group]]
    assert len(names) == len(set(names))
    for e in S[group]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert spec.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and group != "end_to_end" and group != "per_layer":
                assert LINE.match(e[k]), (e["name"], k)
        if "layer" in e:
            assert LINE.match(e["layer"])


def test_configs_and_cells():
    for c in S["configs"]:
        assert c["file"].startswith("benchmark/")
        conf = spec.read_json(spec.REPO / c["file"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert spec.NAME.match(k) and k in conf, k
            assert not k.endswith(("_dim", "_rank")), k
        assert any(w["config"] == c["name"] for w in S["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in S["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in S["workloads"])
    assert [w["name"] for w in S["workloads"]] == [
        "dense4096-drop.sweep8", "overlay65k-churn.sweep8",
        "overlay65k-churn.served"]


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in S["end_to_end"]}
    assert set(e2e) == {"setup_s", "node_ticks_per_s", "request_p95_ms",
                        "request_p50_ms"}
    for m in S["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in S["workloads"]}
    for w in cells:
        reported = {m["name"] for m in spec.metrics_of(S, w, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2, w
        assert spec.metrics_of(S, w, "per_layer"), w
    layers = {}
    for m in S["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert m["moves"] in {x["name"] for x in
                                  spec.metrics_of(S, w, "end_to_end")}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"service", "driver", "routing and host launch prep",
                           "kernels", "device"}


def test_run_seconds_fit_the_full_check():
    per_run = S["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in S["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    r = spec.resolve(S, cell)
    assert r["config"]["name"] == r["workload"]["config"]
    assert (spec.ROOT / "reference" / f"{r['config']['reference']}.py"
            ).is_file()
    for fn in ("setup", "lead_in", "window", "answers", "release"):
        assert callable(getattr(r["driver"], fn))
    want = {m["name"] for g in ("end_to_end", "per_layer")
            for m in spec.metrics_of(S, cell, g)}
    assert set(r["metrics"]) == want
    for _, mod in r["metrics"].values():
        assert callable(mod.read)


def test_files_under_paths_are_named_from_name_characters():
    for p in spec.ROOT.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(spec.REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_no_jax_after_importing_the_harness():
    code = ("import sys; import benchmark.run, benchmark.harness, "
            "benchmark.tools.knee, benchmark.tools.control; "
            "from benchmark import spec; "
            "[spec.resolve(spec.load_spec(), w['name']) "
            " for w in spec.load_spec()['workloads']]; "
            "import gossip_protocol_tpu_torch.core.fleet, "
            "gossip_protocol_tpu_torch.service; "
            "from benchmark.harness import banned_modules; "
            "print(banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_new_config_mix_and_metric_are_files_and_one_entry(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix and a metric
    as new files and one new cell entry, and run the new cell on the CPU:
    no file that was there is edited."""
    from benchmark.harness import run_cell
    root = tmp_path / "benchmark"
    shutil.copytree(spec.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    conf = spec.read_json(root / "configs" / "dense4096-drop.json")
    conf.update(name="dense48-drop", max_nnb=48, total_ticks=120)
    (root / "configs" / "dense48-drop.json").write_text(json.dumps(conf))
    (root / "traffic" / "sweep2.json").write_text(json.dumps(
        {"driver": "sweep", "batch": 2, "in_flight": 1,
         "trace_seconds": 2}))
    (root / "metrics" / "fleet.count.py").write_text(
        "def read(ctx):\n    return len(ctx['record']['fleets'])\n")
    s = json.loads(json.dumps(S))
    s["configs"].append(dict(name="dense48-drop", source="test",
                             file="benchmark/configs/dense48-drop.json",
                             reduced=[], why="test"))
    s["workloads"].append(dict(name="dense48-drop.sweep2",
                               config="dense48-drop", traffic="sweep2",
                               chips=1, why="test"))
    s["end_to_end"].append(dict(name="fleet.count", unit="fleets",
                                better="higher", bound=0.1,
                                source="host_clock",
                                workloads=["dense48-drop.sweep2"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    out = run_cell("dense48-drop.sweep2", 5, 1.0, False, device="cpu",
                   repo=tmp_path, log=lambda m: None)
    assert out["correct"], out
    assert out["metrics"]["fleet.count"]["value"] >= 1
    assert set(out["metrics"]) == {"setup_s", "fleet.count"}
    assert {p: p.read_bytes() for p in before} == before
