"""The port stands alone: repro_torch and chip_smoke.py import neither jax
nor the JAX package, nor msgpack, zstandard, pydantic or ml_dtypes, also
not when they train, resume, serve, merge (``python -m
repro_torch.core.tailor``), save on the canonical path (``python -m
repro_torch.launch.train --no-fingerprint``), supervise a trainer
(``launch/supervisor.py``) and probe a store (``launch/elastic.py``) in
one process; and the subprocess IO workers of ``--io-backend process`` (a
train, its failure and resume, and a server's load through them) import
none of these, nor torch."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "zstandard", "pydantic",
             "ml_dtypes")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m",
                                  "deepseek-v2-lite-16b"])
def test_train_save_resume_loads_no_forbidden_module(tmp_path, arch):
    script = f"""
import sys
from repro_torch.launch.train import SimulatedFailure, train
kw = dict(arch={arch!r}, total_steps=4, batch=2, seq_len=16, seed=0,
          policy_name="parity", ckpt_interval=2, device="cpu",
          num_layers=2, ckpt_dir={str(tmp_path / 'run')!r})
try:
    train(fail_at=3, **kw)
except SimulatedFailure:
    pass
r = train(resume=True, **kw)
assert r["restore_stats"]["step"] == 2, r["restore_stats"]
from repro_torch.launch.serve import serve
s = serve(arch={arch!r}, batch=2, prompt_len=8, new_tokens=2, device="cpu",
          num_layers=2, from_ckpt=kw["ckpt_dir"], from_step=2,
          hot_swap=True, swap_wait=0.0)
assert s["served_step"] == 4 and s["swap"]["step_to"] == 4, s
import json, pathlib, runpy
recipe = pathlib.Path({str(tmp_path / 'recipe.json')!r})
merged = pathlib.Path({str(tmp_path / 'merged')!r})
recipe.write_text(json.dumps({{
    "base": kw["ckpt_dir"] + "@4", "output": str(merged),
    "select": [{{"units": "embed", "from": kw["ckpt_dir"] + "@2"}}]}}))
sys.argv = ["tailor", str(recipe), "--device", "cpu", "--workers", "2"]
runpy.run_module("repro_torch.core.tailor", run_name="__main__")
assert (merged / "LATEST").read_text() == "4"
sys.argv = ["train", "--device", "cpu", "--arch", {arch!r}, "--num-layers",
            "2", "--steps", "6", "--batch", "2", "--seq-len", "16",
            "--policy", "parity", "--ckpt-interval", "2", "--ckpt-dir",
            kw["ckpt_dir"], "--resume", "--no-fingerprint", "--sync-save"]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
m = json.loads((pathlib.Path(kw["ckpt_dir"]) / "manifests"
                / "manifest-00000006.json").read_text())
assert any(r["stored"] == "delta" for k in m["entries"].values()
           for r in k.values()), m
pkw = dict(kw, ckpt_dir={str(tmp_path / 'prun')!r}, io_backend="process",
           io_workers=2)
try:
    train(fail_at=3, **pkw)
except SimulatedFailure:
    pass
r = train(resume=True, **pkw)
assert r["io_backend"] == "process", r
assert r["restore_stats"]["workers"]["tasks"] > 0, r["restore_stats"]
s = serve(arch={arch!r}, batch=2, prompt_len=8, new_tokens=2, device="cpu",
          num_layers=2, from_ckpt=pkw["ckpt_dir"], from_step=2,
          io_backend="process", io_workers=2)
assert s["restore"]["workers"]["tasks"] > 0, s["restore"]
# the worker that decoded a whole restore, asked what it imported
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.models import build_model
model = build_model(get_config({arch!r}, reduced=True).replace(num_layers=2))
mgr = CheckpointManager(pkw["ckpt_dir"], LayerRegistry(model),
                        make_policy("full", model.layer_units()),
                        async_save=False, io_backend="process", io_workers=1)
import torch
mgr.restore(steps.state_specs(model), device=torch.device("cpu"))
assert mgr.last_restore_stats["workers"]["tasks"] > 0
worker_bad = sorted(m for m in mgr.transfer_pool.workers.call("modules")
                    if m.split(".")[0] in {FORBIDDEN!r} + ("torch",))
mgr.close()
# one supervised attempt (a child trainer on the CPU) and a probe
from repro_torch.launch.elastic import probe_restore
from repro_torch.launch.supervisor import Supervisor
rep = Supervisor({str(tmp_path / 'sup')!r}, run_dir={str(tmp_path / 'srun')!r},
                 arch={arch!r}, steps=2, interval=2, num_layers=2,
                 device="cpu", attempt_timeout=240).run()
assert rep["completed"] and rep["attempts"][0]["exit_code"] == 0, rep
assert probe_restore({str(tmp_path / 'sup')!r}, {arch!r}, num_layers=2,
                     device="cpu")["step"] == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r})
print("BAD", bad, "WORKER_BAD", worker_bad)
sys.exit(1 if bad or worker_bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run alone (no repository beside it) or without CUDA, the smoke
    script exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    for script in (lone, ROOT / "chip_smoke.py"):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
