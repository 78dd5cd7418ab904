"""No module that a benchmark run loads has the top-level name jax,
jaxlib, flax or repro (the JAX package), compared whole: repro_torch
passes. A fresh interpreter imports what ``bench/run.py`` imports, then
drives a smoke cell through the runner (which imports the program's
modules as a run does), and lists what it holds."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json, sys, runpy
sys.argv = ["run.py"]
runpy.run_path("bench/run.py", run_name="not_main")
import torch
torch.set_num_threads(1)
from bench import harness as H, smoke
from bench.runners import train as R
for name in ("granite-moe-1b-a400m.train_4k", "zamba2-2.7b.train_4k"):
    R.run(smoke.cell(name), seed=3, seconds=0.1, trace=False,
          device=torch.device("cpu"), t_start=0.0)
print(json.dumps({"bad": H.forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert "repro_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])


def test_without_the_program_a_run_prints_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and bench/ exits non-zero
    and prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "granite-moe-1b-a400m.train_4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "No module named 'repro_torch'" in out.stderr
    assert '"correct"' not in out.stdout
