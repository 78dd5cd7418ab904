"""The torch twins of ``examples/*.py`` (``examples/torch/``), run on the
CPU as scripts, each at its short setting but ``quickstart`` and
``cluster_centers``, which run at the reference scripts' own sizes so
that their printed numbers can be held against the reference scripts'
(run here too, as they are):

  * quickstart: the universal sample's size equal, each segment estimate
    and the merged sketch's sum within rtol 1e-5 (the exact values within
    rtol 1e-6: float32 sums in another order);
  * cluster_centers: the slab's members and HT count equal, each search's
    sample-LS cost ratio (exact cost of the sample's result over the
    exact-scored search's) equal to the printed three decimals;
  * serve_batched (2 generated tokens), train_with_sampled_telemetry (1
    step) and gradient_compression_demo (2 steps on 8 gloo processes) run
    to their end and print what their references print; the training
    twin leaves no checkpoint directory behind in its TMPDIR.

Every script runs in its own process, all of them at once, with 2
threads each.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RUNS = {
    "quickstart": ["examples/torch/quickstart.py", "--device", "cpu"],
    "quickstart ref": ["examples/quickstart.py"],
    "cluster": ["examples/torch/cluster_centers.py", "--device", "cpu"],
    "cluster ref": ["examples/cluster_centers.py"],
    "serve": ["examples/torch/serve_batched.py", "--device", "cpu",
              "--gen", "2"],
    "train": ["examples/torch/train_with_sampled_telemetry.py", "--device",
              "cpu", "--steps", "1"],
    "demo": ["examples/torch/gradient_compression_demo.py", "--device",
             "cpu", "--steps", "2"],
}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{run: (return code, stdout, its TMPDIR)} of every script above."""
    procs = {}
    for name, argv in RUNS.items():
        tmp = tmp_path_factory.mktemp(name.replace(" ", "_"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
                   JAX_PLATFORMS="cpu", TMPDIR=str(tmp))
        if name == "demo":
            env["OMP_NUM_THREADS"] = "1"
        procs[name] = (subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    out = {}
    try:
        for name, (p, tmp) in procs.items():
            text = p.communicate(timeout=400)[0]
            out[name] = (p.returncode, text, tmp)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _ok(outputs, name) -> str:
    rc, text, _ = outputs[name]
    assert rc == 0, text[-3000:]
    return text


def _floats(pattern, text):
    return [float(x.replace(",", "")) for x in re.findall(pattern, text)]


def test_quickstart_matches_the_reference_script(outputs):
    got, want = _ok(outputs, "quickstart"), _ok(outputs, "quickstart ref")
    size = r"sample size: (\d+) of (\d+) keys \(bound k ln n = (\d+)\)"
    assert re.findall(size, got) == re.findall(size, want) != []
    est = r"est\s+([-\d.]+)\s+exact\s+([-\d.]+)"
    g, w = re.findall(est, got), re.findall(est, want)
    assert len(g) == len(w) == 5
    for (ge, gx), (we, wx) in zip(g, w):
        # float32 sums in another order: the printed tenths may differ
        assert abs(float(gx) - float(wx)) <= 1e-6 * abs(float(wx)) + 0.1
        assert abs(float(ge) - float(we)) <= 1e-5 * abs(float(we)) + 0.1
    merged = r"merged-sketch sum estimate: ([-\d.]+)  \(exact ([-\d.]+)\)"
    (gm, gx), = re.findall(merged, got)
    (wm, wx), = re.findall(merged, want)
    assert gx == wx
    assert abs(float(gm) - float(wm)) <= 1e-5 * abs(float(wm)) + 0.1


def test_cluster_centers_matches_the_reference_script(outputs):
    got, want = _ok(outputs, "cluster"), _ok(outputs, "cluster ref")
    slab = r"slab members=(\d+), HT count estimate=(\d+)"
    assert re.findall(slab, got) == re.findall(slab, want) != []
    ratio = r"\[(k-means|k-median)\].*\(ratio ([\d.]+)\)"
    assert re.findall(ratio, got) == re.findall(ratio, want)
    assert len(re.findall(ratio, got)) == 2


def test_serve_batched_twin_serves_and_reports_telemetry(outputs):
    text = _ok(outputs, "serve")
    assert "generated token ids (first row)" in text
    assert _floats(r"est requests: ([\d.]+)", text) == [4.0]
    assert "[cluster] request-shape centers" in text


def test_train_twin_steps_and_cleans_its_checkpoints(outputs):
    text = _ok(outputs, "train")
    loss = _floats(r"step\s+1 loss\s+([-\d.]+)", text)
    assert len(loss) == 1 and loss[0] == loss[0] and loss[0] > 0
    assert _floats(r"\[telemetry\] sketch size: (\d+)", text) == [8.0]
    assert not list(outputs["train"][2].glob("repro_torch_ckpt_*"))


def test_gradient_compression_demo_reports_both_curves(outputs):
    text = _ok(outputs, "demo")
    rows = re.findall(r"^\s*(\d+) \|\s+([-\d.]+) \|\s+([-\d.]+)$", text,
                      re.M)
    assert [int(r[0]) for r in rows] == [0, 1]
    dense, sampled = ([float(r[i]) for r in rows] for i in (1, 2))
    # the first step's loss is taken before any exchange
    assert dense[0] == sampled[0] and dense[1] < dense[0]
    assert sampled[1] < sampled[0]
    (d_bytes, s_bytes), = re.findall(
        r"dense all-reduce ([\d,]+), sampled exchange ([\d,]+)", text)
    assert 0 < int(s_bytes.replace(",", "")) < int(d_bytes.replace(",", ""))
