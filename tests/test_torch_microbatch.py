"""Microbatches cut from the global batch, across 8 CPU processes over gloo
on the reference's (pod 2, data 2, model 2) mesh.

The reference cuts the global batch (the pod's under the sampled
exchange) into ``microbatch`` parts of consecutive rows and lets GSPMD
share each part over the batch axes (``src/repro/launch/steps.py``
``split``). The port's placed step takes each rank's share of each part
(``sharding.batch_share``: ceil(m / ranks) rows a rank, a short or empty
share padded with rows that weigh zero). Each case's first step, with
activations in float32, against the JAX package's own
``make_train_step(..., microbatch=2)`` on one CPU device:

  * qwen2-1.5b (dense), 12 rows: parts of 6 over 4 batch ranks (2, 2, 2
    and an empty share);
  * granite-moe-1b-a400m (MoE), 6 rows: parts of 3, fewer than the 4
    batch ranks, so one rank holds only padding in every part;
  * granite-moe-1b-a400m under the sampled exchange, 12 rows: each pod's
    6 rows in parts of 3 over its 2 data ranks (2 and 1); the gradient
    each pod hands to the exchange against the reference's step on that
    pod's rows, and the loss against the mean of the two pods'.

Losses rtol 1e-5 and every gradient element within 1e-5 of its leaf's
largest (``tests/test_torch_placement.py``'s bars for placed steps). The
MoE balance loss is not linear in the batch, so the grouping matters: the
reference's gradients with the rows grouped as a split of each rank's own
rows would group them differ by more than that bar.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as RR
from repro.launch import steps as RSt
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch.launch import sharding as TSh
from repro_torch.launch import steps as TSt
from repro_torch.models import parallel as TP
from repro_torch import tree as TT

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
LOSS_REL = GRAD_REL = 1e-5
OPT = dict(total_steps=60, warmup_steps=3, peak_lr=5e-3)
# (case, arch, global rows, sampled exchange)
CASES = (("dense", "qwen2-1.5b", 12, False),
         ("moe", "granite-moe-1b-a400m", 6, False),
         ("moe compressed", "granite-moe-1b-a400m", 12, True))
SEQ = 32

_WORKER = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    from repro_torch import interop, tree as TT
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distopt import compression as CP
    from repro_torch.launch import sharding as Sh
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as Mod
    from repro_torch.optim import adamw

    inp = pickle.load(open(f"{out}/inputs.pkl", "rb"))
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    Mod.ACT_DTYPE = torch.float32
    opt = adamw.OptConfig(**inp["opt"])
    res = {"coords": mesh.coords}
    whole = lambda g, specs: {p: x.numpy().copy() for p, x in TT.flatten(
        Sh.unplace(g, specs, mesh))}
    for case, arch, rows, compressed in inp["cases"]:
        cfg = get_smoke_config(arch)
        tree = interop.model_params_from_arrays(cfg, inp["params"][arch],
                                                device="cpu")
        seen = []
        exchange = CP.exchange_grads

        def hook(grads, params, step):
            if not compressed:
                seen.append(whole(grads, specs["params"]))
            return grads

        def capturing_exchange(mesh_, grads, *a, **kw):
            seen.append(whole(grads, specs["params"]))
            return exchange(mesh_, grads, *a, **kw)
        CP.exchange_grads = capturing_exchange
        try:
            step, specs = St.make_train_step(
                cfg, opt, mesh, grad_transform=hook, microbatch=2,
                compress=dict(k=64, min_size=1024) if compressed else None)
            st = Sh.place({"params": tree,
                           "opt": adamw.init_opt_state(tree)}, specs, mesh)
            _, m = step(st, {k: torch.from_numpy(v)
                             for k, v in inp["batches"][case].items()})
        finally:
            CP.exchange_grads = exchange
        res[case] = {"loss": float(m["loss"]), "grads": seen[0]}
    dist.barrier()
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tokens(rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 128, (rows, SEQ)).astype(
        np.int32)


def _inputs():
    params = {a: jax.tree.map(np.asarray, RM.init_model(
        jax.random.PRNGKey(0), RR.get_smoke_config(a))[0])
        for _, a, _, _ in CASES}
    batches = {case: {"tokens": _tokens(rows, 20 + i)}
               for i, (case, _, rows, _) in enumerate(CASES)}
    return {"opt": OPT, "params": params, "batches": batches,
            "cases": CASES}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("microbatch")
    inp = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    ranks = [pickle.load(open(out / f"rank{r}.pkl", "rb"))
             for r in range(WORLD)]
    return inp, ranks


def _reference_step(arch, params, tokens):
    """The JAX package's microbatch-2 train step on one CPU device (float32
    activations): (loss, {path: gradient})."""
    cfg = RR.get_smoke_config(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                             ("pod", "data", "model"))
    stash = []

    def hook(grads, params_, step):
        paths = [p for p, _ in TT.flatten(grads)]
        jax.debug.callback(lambda *leaves: stash.append(dict(zip(
            paths, (np.asarray(x) for x in leaves)))),
            *[g for _, g in TT.flatten(grads)])
        return grads
    old = RM.ACT_DTYPE
    RM.ACT_DTYPE = jnp.float32
    try:
        step, _ = RSt.make_train_step(cfg, RA.OptConfig(**OPT), mesh,
                                      grad_transform=hook, microbatch=2,
                                      donate=False)
        p = jax.tree.map(jnp.asarray, params)
        _, m = step({"params": p, "opt": RA.init_opt_state(p)},
                    {"tokens": jnp.asarray(tokens)})
        loss = float(m["loss"])
        jax.effects_barrier()
    finally:
        RM.ACT_DTYPE = old
    return loss, stash[0]


def _grads_close(got, want, what):
    assert set(got) == set(want), what
    for path, w in want.items():
        gap = float(np.abs(got[path] - w).max())
        assert gap <= GRAD_REL * float(np.abs(w).max()), (what, path, gap)


@pytest.mark.parametrize("case,arch,rows,compressed", CASES)
def test_placed_microbatch_step_equals_the_reference(run, case, arch, rows,
                                                     compressed):
    inp, ranks = run
    tokens = inp["batches"][case]["tokens"]
    params = inp["params"][arch]
    losses = {r[case]["loss"] for r in ranks}
    assert len(losses) == 1, losses
    if not compressed:
        want_loss, want_grads = _reference_step(arch, params, tokens)
        np.testing.assert_allclose(ranks[0][case]["loss"], want_loss,
                                   rtol=LOSS_REL)
        for r in ranks:
            _grads_close(r[case]["grads"], want_grads, case)
        return
    half = rows // 2
    per_pod = [_reference_step(arch, params, tokens[p * half:(p + 1) * half])
               for p in (0, 1)]
    np.testing.assert_allclose(ranks[0][case]["loss"],
                               (per_pod[0][0] + per_pod[1][0]) / 2,
                               rtol=LOSS_REL)
    for r in ranks:
        _grads_close(r[case]["grads"], per_pod[r["coords"]["pod"]][1],
                     f"{case} pod {r['coords']['pod']}")


def test_moe_step_depends_on_the_grouping():
    """The reference's microbatch-2 MoE step over 8 rows, against the same
    step with the rows grouped as a split of each of 4 ranks' own 2 rows
    would group them (part j: each rank's j-th row). The balance loss is
    not linear in a part's rows, so the gradients differ by more than the
    bar the placed step is held to (the router's by ~90x). The loss moves
    less than its own bar: the smoke config's z loss (~4e4 x 0.001) is
    linear in the rows and dominates it, so only its ulps show the
    change."""
    arch = "granite-moe-1b-a400m"
    params = jax.tree.map(np.asarray, RM.init_model(
        jax.random.PRNGKey(0), RR.get_smoke_config(arch))[0])
    tokens = _tokens(8, 7)
    per_rank = np.arange(8).reshape(4, 2).T.reshape(-1)   # 0 2 4 6 1 3 5 7
    loss, grads = _reference_step(arch, params, tokens)
    loss2, grads2 = _reference_step(arch, params, tokens[per_rank])
    assert loss2 != loss
    off = {p: float(np.abs(grads2[p] - g).max())
           / (GRAD_REL * float(np.abs(g).max())) for p, g in grads.items()}
    assert off["layers.moe.router"] > 10, off


class _FakeMesh:
    def __init__(self, shape, coords):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = coords


@pytest.mark.parametrize("n,axes,want", [
    (6, ("pod", "data"), [(0, 2), (2, 4), (4, 6), (6, 6)]),
    (3, ("pod", "data"), [(0, 1), (1, 2), (2, 3), (3, 3)]),
    (8, ("pod", "data"), [(0, 2), (2, 4), (4, 6), (6, 8)]),
    (3, ("data",), [(0, 2), (2, 3), (0, 2), (2, 3)]),
])
def test_batch_share_lays_rows_out_as_gspmd(n, axes, want):
    """ceil(n / ranks) rows a rank in row-major (pod, data) order, the last
    shares short or empty; every share's full size is the same."""
    got = []
    for i in range(4):
        mesh = _FakeMesh({"pod": 2, "data": 2, "model": 1},
                         {"pod": i // 2, "data": i % 2, "model": 0})
        share, size = TSh.batch_share(mesh, n, axes)
        got.append((share.start, share.stop))
        assert size == -(-n // (4 if len(axes) == 2 else 2))
    assert got == want


def test_a_batch_that_does_not_split_into_the_parts_raises():
    """The one check left is the reference's reshape: the batch must split
    into the microbatches, and the message names both numbers."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw as TA
    cfg = get_smoke_config("qwen2-1.5b")
    mesh = Mesh((1, 1), ("data", "model"), device="cpu")
    step, specs = TSt.make_train_step(cfg, TA.OptConfig(), mesh,
                                      microbatch=4)
    params, _ = TM.init_model(cfg, seed=0, device="cpu")
    state = TSh.place({"params": params, "opt": TA.init_opt_state(params)},
                      specs, mesh)
    with pytest.raises(ValueError, match="batch of 6 rows.*4 microbatches"):
        step(state, {"tokens": torch.zeros((6, 16), dtype=torch.int32)})


def test_padding_rows_weigh_nothing():
    """A placed loss over rows of which some pad the share: the padded
    rows' tokens change neither the loss nor its gradient."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"))
    mesh = Mesh((1, 1), ("data", "model"), device="cpu")
    params, specs = TM.init_model(cfg, seed=0, device="cpu")
    psp = TSh.param_pspecs(specs, params, mesh)
    valid = torch.tensor([True, True, False])
    sh = TP.Shards(mesh, psp).with_rows(valid, 2)
    rng = np.random.default_rng(3)
    real = torch.from_numpy(rng.integers(0, 128, (2, 16)).astype(np.int32))
    out = []
    for pad in (0, 5):
        model = TM.Model(cfg, params, sh)
        tokens = torch.cat([real, torch.full((1, 16), pad,
                                             dtype=torch.int32)])
        loss, _ = model({"tokens": tokens})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss.detach(), grads))
    one = TM.Model(cfg, params, TP.Shards(mesh, psp))
    loss1, _ = one({"tokens": real})
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    torch.testing.assert_close(out[0][0], loss1.detach(), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
