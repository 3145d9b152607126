"""The port stands alone: repro_torch and chip_smoke.py import neither jax
nor the JAX package, nor msgpack, pydantic or ml_dtypes."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "pydantic", "ml_dtypes")


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


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m"])
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r})
print("BAD", bad)
sys.exit(1 if bad else 0)
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
