"""The benchmark's harness: it finds a cell's configuration, traffic mix,
runner, limits and per-layer metrics by the names in ``BENCHMARK.json``,
looks for the card, runs the cell and prints the result's line.

Everything that belongs to one cell is a file of its own, found by name:

  bench/configs/<config>.json    the configuration as it is run
  bench/traffic/<traffic>.json   the traffic mix; its "runner" names
  bench/runners/<runner>.py      the code that drives the program
  bench/metrics/<metric>.py      one per-layer metric's reader
  bench/limits/<workload>.json   the limits of the cell's correctness checks

A later cell, metric or runner is new files and a new entry in
``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _metrics_of(spec: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in spec:
        return cell in spec["workloads"]
    return spec["moves"] in e2e_names if "moves" in spec else True


def resolve(name: str, bench: dict | None = None) -> Cell:
    """The cell called ``name`` in BENCHMARK.json, with everything its
    files hold."""
    bench = benchmark() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = make_cell(name, ROOT / cfg["file"], w["traffic"], w["chips"],
                     bench)
    cell.workload = w
    return cell


def make_cell(name: str, config_file: Path | dict, traffic: str,
              chips: int = 1, bench: dict | None = None) -> Cell:
    """A cell from its files: the configuration (a file, or the dict it
    would hold), the traffic mix and the limits
    (``bench/limits/<name>.json``), with the metrics of BENCHMARK.json
    that it reports."""
    bench = benchmark() if bench is None else bench
    limits_path = BENCH / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _metrics_of(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _metrics_of(m, name, names)]
    config = (json.loads(json.dumps(config_file))     # a deep copy
              if isinstance(config_file, dict) else load_json(config_file))
    return Cell(name, {"name": name, "traffic": traffic, "chips": chips},
                config, load_json(BENCH / "traffic" / f"{traffic}.json"),
                limits, e2e, per, chips)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(kind: str):
    return load_module(BENCH / "runners" / f"{kind}.py",
                       f"bench_runner_{kind}")


def metric(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    that no run may hold."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def checks_line(checks: dict) -> list:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]


def emit(result: dict):
    """The checks as the last lines of stderr; the result as the last line
    of stdout, its "checks" key last."""
    checks = result.pop("checks")
    result["checks"] = checks
    for line in checks_line(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = resolve(args.workload)
    import repro_torch  # noqa: F401  (the program: a run needs it)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    if not cell.limits:
        print(f"{cell.name} has no limits file", file=sys.stderr)
        return 2
    run = runner(cell.traffic["runner"])
    result = run.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda"),
                     t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that no run may load were loaded: {bad}",
              file=sys.stderr)
        return 4
    emit(result)
    return 0
