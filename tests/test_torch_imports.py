"""The port stands alone, and runs on the card unless told otherwise.

* no module of ``gossip_protocol_tpu_torch`` and not ``chip_smoke.py``
  imports JAX or the JAX package (``gossip_protocol_tpu`` not followed
  by ``_torch``): a GPU host running the port need not have JAX;
* asking for ``cuda`` (or leaving the device at its default) without a
  visible card raises instead of running on the CPU;
* on CPU tensors every kernel wrapper runs its plain version and counts
  no launch.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.sim import Simulation
from gossip_protocol_tpu_torch.state import init_state, resolve_device
from tests.conftest import TESTCASES

REPO = os.path.dirname(TESTCASES)
PKG = os.path.join(REPO, "gossip_protocol_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax") or top == "gossip_protocol_tpu"


def test_no_jax_imports():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), node.lineno, n)
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_ops_layer_imports_no_model_layer():
    """The kernels, their plain versions and the shared rules under
    ``ops/`` sit below the orchestration: nothing there imports
    ``models/`` or ``core/``, at module level or inside a function."""
    bad = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if not rel.startswith(os.path.join("gossip_protocol_tpu_torch",
                                           "ops")):
            continue
        pkg = os.path.dirname(rel).split(os.sep)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                base = pkg[:len(pkg) - node.level + 1] if node.level else []
                names = [".".join(base + (node.module or "").split("."))]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            bad += [(rel, node.lineno, n) for n in names
                    if n.startswith(("gossip_protocol_tpu_torch.models",
                                     "gossip_protocol_tpu_torch.core"))]
    assert not bad, bad


def test_package_imports_without_jax(tmp_path):
    """Import every port module in a fresh interpreter where ``jax`` and
    ``gossip_protocol_tpu`` cannot be imported at all."""
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for p in _port_files() if p.startswith(PKG))
    blocker = tmp_path / "sitecustomize.py"
    blocker.write_text(
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'gossip_protocol_tpu'):\n"
        "    sys.modules[m] = None\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), REPO])
    code = "import importlib\nfor m in %r:\n    importlib.import_module(m)\n"
    subprocess.run([sys.executable, "-c", code % (mods,)], check=True,
                   env=env, cwd=str(tmp_path))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")


def test_cuda_without_a_card_raises():
    _no_card()
    from gossip_protocol_tpu_torch.models.overlay import (OverlaySimulation,
                                                          init_overlay_state)
    cfg = SimConfig(max_nnb=16)
    ocfg = SimConfig(max_nnb=16, model="overlay")
    for call in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                 lambda: Simulation(cfg), lambda: init_state(cfg),
                 lambda: OverlaySimulation(ocfg),
                 lambda: init_overlay_state(ocfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_cli_defaults_to_cuda(tmp_path):
    _no_card()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "gossip_protocol_tpu_torch",
         os.path.join(TESTCASES, "singlefailure.conf"), "--quiet"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "dbg.log").exists()


def test_overlay_cli_defaults_to_cuda(tmp_path):
    _no_card()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "gossip_protocol_tpu_torch",
         os.path.join(TESTCASES, "singlefailure.conf"), "--model", "overlay",
         "-n", "16", "--ticks", "20"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_overlay_wrappers_on_cpu_count_no_launch():
    from gossip_protocol_tpu_torch.models.overlay import (
        OverlaySimulation, init_overlay_state, make_overlay_run,
        make_overlay_schedule)
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import \
        fused_overlay_tick
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        grid_overlay_ticks
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import \
        mega_overlay_ticks
    wrappers = (fused_overlay_tick, mega_overlay_ticks, grid_overlay_ticks)
    before = [f.launches for f in wrappers]
    cfg = SimConfig(max_nnb=16, model="overlay", total_ticks=40)
    res = OverlaySimulation(cfg, device="cpu").run()            # K4 route
    f8 = cfg.replace(topology="powerlaw")
    OverlaySimulation(f8, device="cpu").run()                   # K5 route
    make_overlay_run(f8, 20, grid=False)(                       # K3 route
        init_overlay_state(f8, "cpu"), make_overlay_schedule(f8))
    after = [f.launches for f in wrappers]
    assert after == before
    assert res.final_state.device.type == "cpu"
    assert int(res.metrics.in_group[-1]) == 16


def test_wrappers_on_cpu_count_no_launch():
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import \
        dense_mega_ticks
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import tick_epilogue
    from gossip_protocol_tpu_torch.ops.drop import drop_masks
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    wrappers = (masked_max3, tick_epilogue, dense_mega_ticks, drop_masks)
    before = [f.launches for f in wrappers]
    cfg = SimConfig(max_nnb=16, total_ticks=40, drop_msg=True,
                    drop_open_tick=5, drop_close_tick=30)
    res = Simulation(cfg, device="cpu").run()          # K2 route
    Simulation(cfg.replace(max_nnb=10), device="cpu").run()   # per-tick
    after = [f.launches for f in wrappers]
    assert after == before
    assert res.final_state.device.type == "cpu"
    assert np.asarray(res.sent).sum() > 0
