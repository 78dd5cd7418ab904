"""The port's dry run and cost model (``repro_torch.launch.dryrun``,
``repro_torch.launch.cost``) against the reference's
(``repro.launch.dryrun``'s lowering, ``repro.launch.hlo_cost``).

Each side runs in a subprocess of its own, on the same four smoke cells at
(pod 2, data 2, model 2) and a global batch of 8 x 32: dense (qwen2-1.5b)
and ssm (falcon-mamba-7b) train steps, hybrid (zamba2-2.7b) and moe
(granite-moe-1b-a400m) prefill steps.

  * the reference: 8 CPU devices (``--xla_force_host_platform_device_count``,
    as tests/test_distribution.py), ``make_*_step(...).lower().compile()``,
    ``memory_analysis()`` and ``hlo_cost.analyze``. Lowered without
    ``mesh_context``: under JAX 0.9 its ``jax.set_mesh`` puts the trace in
    explicit-sharding mode, where GSPMD gathers every weight and the
    qwen2 train step costs 186,591,425 flops (7.6x) with 58 all-gathers;
  * the port: rank 0 of a ``fake`` 8-rank group (``mesh.init_dry_group``),
    ``dryrun.measure_step`` on meta tensors.

Per-rank ``argument_size_in_bytes`` equal the reference's exactly (no leaf
differs). ``matmul_flops`` and the collectives equal closed forms from the
config and the rank's shapes (derived below); they are not compared with
GSPMD's collectives, which are others (all-to-all, collective-permute).
``flops`` is held to the ratio measured against the reference's count:
the elementwise part differs by construction (XLA fuses and rewrites, the
eager port counts each op it runs).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models.moe import moe_capacity
from repro_torch import tree as TT
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("qwen2-1.5b", "train"), ("falcon-mamba-7b", "train"),
         ("zamba2-2.7b", "prefill"), ("granite-moe-1b-a400m", "prefill"))
MESH = {"pod": 2, "data": 2, "model": 2}
B, S = 8, 32
# the port's flops over the reference's hlo_cost flops, as measured (the
# port counts 1 per element of each op it runs; XLA fuses, and its scans
# and softmaxes lower to more elementwise ops than the eager code runs)
FLOPS_RATIO = {"qwen2-1.5b train": 0.959, "falcon-mamba-7b train": 0.574,
               "zamba2-2.7b prefill": 1.009,
               "granite-moe-1b-a400m prefill": 0.973}

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.configs.registry import get_smoke_config
    from repro.configs.shapes import ShapeConfig
    from repro.launch import hlo_cost, steps as St
    from repro.optim import adamw
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for arch, kind in @CELLS@:
        cfg = get_smoke_config(arch)
        shape = ShapeConfig("smoke", @S@, @B@, kind)
        if kind == "train":
            step, _ = St.make_train_step(cfg, adamw.OptConfig(), mesh,
                                         shape=shape)
            args = (St.abstract_state(cfg)[0], St.input_specs(cfg, shape))
        else:
            step, _ = St.make_prefill_step(cfg, mesh, shape=shape)
            args = (St.abstract_params(cfg)[0], St.input_specs(cfg, shape))
        compiled = step.lower(*args).compile()
        mem = compiled.memory_analysis()
        out[f"{arch} {kind}"] = {
            "argument_size_in_bytes": mem.argument_size_in_bytes,
            "hlo_cost": hlo_cost.analyze(compiled.as_text())}
    print("RESULT " + json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.launch.mesh import Mesh, init_dry_group
    init_dry_group(8)
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    out = {}
    for arch, kind in @CELLS@:
        mem, hlo, _ = measure_step(get_smoke_config(arch),
                                   ShapeConfig("smoke", @S@, @B@, kind), mesh)
        out[f"{arch} {kind}"] = {"memory": mem, "hlo_cost": hlo}
    print("RESULT " + json.dumps(out))
""")


def _run(code: str, timeout: int = 600) -> dict:
    for k, v in (("@CELLS@", repr(CELLS)), ("@S@", str(S)), ("@B@", str(B))):
        code = code.replace(k, v)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def reference():
    return _run(_REFERENCE)


@pytest.fixture(scope="module")
def port():
    return _run(_PORT)


def _cell(key):
    arch, kind = key.split(" ")
    return ref_smoke(arch), kind


def test_argument_bytes_equal_the_reference(reference, port):
    """The rank's placed state (params, both moments, the step) or params,
    and its rows of the batch: XLA's ``argument_size_in_bytes``."""
    for key, want in reference.items():
        assert port[key]["memory"]["argument_size_in_bytes"] \
            == want["argument_size_in_bytes"], key


# ------------------------------------------------------------ closed forms
def _shapes(cfg):
    """Rank 0's shapes at MESH: rows, tokens, and the model-axis parts."""
    m = MESH["model"]
    rows = B // (MESH["pod"] * MESH["data"])
    H_l = cfg.num_heads // m
    return dict(m=m, rows=rows, T=rows * S, H_l=H_l,
                kv_l=cfg.num_kv_heads * cfg.head_dim // m,
                ff_l=cfg.d_ff // m, V_l=cfg.vocab_padded // m,
                c=cfg.d_inner // m)


def _tiles(cfg) -> int:
    """Causal (q chunk, kv chunk) tiles at S: n (n + 1) / 2."""
    n = S // min(cfg.attn_chunk, S)
    return n * (n + 1) // 2


def _attention_parts(cfg, r):
    """(the block's projections, one tile's score product) of one rank's
    attention: its q heads' columns, its kv heads' columns (the rank's own
    blocks: the kv split is whole heads here), its rows of wo; a tile is
    2·rows·C·H_l·C·hd for each of QK^T and PV."""
    lin = lambda i, o: 2 * r["T"] * i * o
    d, hd = cfg.d_model, cfg.head_dim
    q_l = r["H_l"] * hd
    proj = lin(d, q_l) + 2 * lin(d, r["kv_l"]) + lin(q_l, d)
    C = min(cfg.attn_chunk, S)
    return proj, 2 * r["rows"] * C * r["H_l"] * C * hd


def _mlp(cfg, r):
    """(the MLP's products, its last one: wo's rows)."""
    lin = lambda i, o: 2 * r["T"] * i * o
    last = lin(r["ff_l"], cfg.d_model)
    return 2 * lin(cfg.d_model, r["ff_l"]) + last, last


def _matmul_closed_form(cfg, kind) -> int:
    """2·M·N·K summed over the products one rank runs. Train: each layer
    is recomputed in backward (remat), whose recompute stops once every
    saved tensor is back, i.e. before the block's last product (the MLP's
    wo, Mamba's out_proj, whose outputs only feed a sum); the backward
    takes 2 products per forward product (the input's and the weight's
    gradients); an attention tile runs QK^T and PV forward and again in
    the recompute, and 5 products backward (the scores again, dV, dP, dK,
    dQ); the loss's vocab product runs forward, recomputed (the loss
    chunk is checkpointed) and twice backward. Mamba-1's scan contracts
    h [B,C,c,N] with C [B,C,N] forward, in the layer's recompute and twice
    backward (the chunk's own recompute stops before it); its depthwise
    conv 2·c·K·T forward, recomputed, and twice backward. Prefill: the
    forward, then the last position's logits."""
    r = _shapes(cfg)
    T, d = r["T"], cfg.d_model
    lin = lambda i, o: 2 * T * i * o
    if kind == "prefill":
        total = 2 * r["rows"] * d * r["V_l"]             # last-position logits
        proj, tile = _attention_parts(cfg, r)
        attn = proj + 2 * _tiles(cfg) * tile
        if cfg.family == "moe":
            E_l = (cfg.num_experts_padded or cfg.num_experts) // r["m"]
            rows = r["rows"] * moe_capacity(S, cfg)     # each expert's slots
            experts = 3 * 2 * E_l * rows * d * cfg.d_ff
            return total + cfg.num_layers * (attn + lin(d, cfg.num_experts)
                                             + experts)
        # hybrid: Mamba-2 layers, the shared block after each group
        N, c, K = cfg.ssm_state, r["c"], cfg.ssm_conv
        Ck = S // max(S // cfg.ssm_chunk, 1)
        mamba2 = (2 * lin(d, c) + 2 * lin(d, N) + lin(d, cfg.ssm_heads)
                  + 2 * c * K * T + 2 * (2 * N * K * T)     # the convs
                  + 2 * r["rows"] * S * Ck * N              # C B^T, every rank
                  + 2 * r["rows"] * S * Ck * c              # intra-chunk
                  + 2 * (2 * T * c * N)                     # h in, h out
                  + lin(c, d))
        groups = cfg.num_layers // cfg.attn_every
        return (total + cfg.num_layers * mamba2
                + groups * (attn + _mlp(cfg, r)[0]))
    loss = 4 * lin(d, r["V_l"])
    if cfg.family == "dense":
        proj, tile = _attention_parts(cfg, r)
        mlp, last = _mlp(cfg, r)
        per = 4 * (proj + mlp) - last + 9 * _tiles(cfg) * tile
        return loss + cfg.num_layers * per
    # ssm: Mamba-1
    N, c, K = cfg.ssm_state, r["c"], cfg.ssm_conv
    R = max(d // 16, 1)
    per = (4 * (2 * lin(d, c) + lin(c, R + 2 * N) + lin(R, c))
           + 3 * lin(c, d) + 4 * 2 * T * c * N + 4 * 2 * c * K * T)
    return loss + cfg.num_layers * per


def _collective_closed_form(cfg, kind, param_bytes: int):
    """(all-reduce count, all-gather count, bytes, bytes across pods) of one
    rank: one sum per row-parallel product forward (attention's wo, the
    MLP's wo, the MoE's experts, Mamba's out_proj) and per replicated
    input entering a column-parallel part backward (``copy_to``); Mamba-1's
    x_proj summed forward, in the recompute and backward; Mamba-2's gated
    norm's sum of squares forward; the vocab-parallel lookup's sum; the
    loss's max, sum of exp and label logit per chunk, forward and in the
    recompute; a prefill's whole k/v for the cache gathered over model,
    Mamba-2's h gathered (its cache block is on hd, not the rank's
    channels), the last logits gathered over model, then the rows over
    data and pod; train: the loss and metrics packed and every gradient
    leaf averaged over data, then over pod, and the grad norm's sum of
    squares over model. Activations in bfloat16, the embedding and the
    loss's statistics in float32."""
    r = _shapes(cfg)
    T, d = r["T"], cfg.d_model
    act = T * d * 2
    emb = T * d * 4
    ar = ag = nbytes = xpod = 0
    if kind == "train":
        nC = S // min(cfg.loss_chunk, S)
        if cfg.family == "dense":
            per_ar, per_b = 5, 5 * act          # 2 fwd, 1 recompute, 2 bwd
        else:                                   # Mamba-1
            proj = T * (max(d // 16, 1) + 2 * cfg.ssm_state) * 2
            per_ar, per_b = 5, 3 * proj + 2 * act
        ar = cfg.num_layers * per_ar + 1 + 6 * nC + 1
        nbytes = (cfg.num_layers * per_b + emb + 6 * nC * r["rows"]
                  * min(cfg.loss_chunk, S) * 4 + act)
        leaves = len(TT.leaves(TM.abstract_params(cfg)[0]))
        ar += 2 * (1 + leaves) + 1 + 2
        nbytes += 2 * (16 + param_bytes) + 4 + 2 * 4
        xpod = 16 + param_bytes + 4
        return ar, ag, nbytes, xpod
    kv_gather = 2 * T * r["kv_l"] * 2           # k and v, bf16
    logits = r["rows"] * r["V_l"] * 4
    rows = [r["rows"] * cfg.vocab_padded * 4,
            MESH["data"] * r["rows"] * cfg.vocab_padded * 4]
    if cfg.family == "moe":
        # the balance loss's two [E] statistics per layer, averaged over
        # data and over pod
        L, stat = cfg.num_layers, 4 * cfg.num_experts
        ar = 1 + 2 * L + 4 * L
        nbytes = emb + 2 * L * act + 4 * L * stat
        ag = 2 * L + 1 + 2
        nbytes += L * kv_gather + logits + sum(rows)
        return ar, ag, nbytes, rows[1] + 2 * L * stat
    L, G = cfg.num_layers, cfg.num_layers // cfg.attn_every
    h = r["rows"] * r["c"] * cfg.ssm_state * 4
    ar = 1 + 2 * L + 2 * G
    nbytes = emb + L * (r["rows"] * S * 4 + act) + 2 * G * act
    ag = L + 2 * G + 1 + 2
    nbytes += L * h + G * kv_gather + logits + sum(rows)
    return ar, ag, nbytes, rows[1]


@pytest.mark.parametrize("key", [f"{a} {k}" for a, k in CELLS])
def test_matmul_flops_equal_the_closed_form(port, key):
    cfg, kind = _cell(key)
    assert port[key]["hlo_cost"]["matmul_flops"] == \
        _matmul_closed_form(cfg, kind)


@pytest.mark.parametrize("key", [f"{a} {k}" for a, k in CELLS])
def test_collectives_equal_the_closed_form(port, key):
    cfg, kind = _cell(key)
    got = port[key]["hlo_cost"]
    # a train rank's argument bytes: params, m and v alike, the int32
    # step and its 2 rows of 32 int32 tokens
    param_bytes = ((port[key]["memory"]["argument_size_in_bytes"]
                    - 4 - 2 * S * 4) // 3 if kind == "train" else 0)
    ar, ag, nbytes, xpod = _collective_closed_form(cfg, kind, param_bytes)
    assert got["coll_ops"].get("all-reduce", 0) == ar
    assert got["coll_ops"].get("all-gather", 0) == ag
    assert set(got["coll_ops"]) <= {"all-reduce", "all-gather"}
    assert got["coll_bytes"] == nbytes
    assert got["coll_bytes_xpod"] == xpod


def test_flops_hold_the_measured_ratio_to_the_reference(reference, port):
    for key, want in reference.items():
        ratio = port[key]["hlo_cost"]["flops"] / want["hlo_cost"]["flops"]
        assert abs(ratio - FLOPS_RATIO[key]) <= 0.02, (key, ratio)
        assert port[key]["hlo_cost"]["flops"] \
            > port[key]["hlo_cost"]["matmul_flops"]


def test_production_cell_through_the_cli(tmp_path):
    """zamba2-2.7b x decode_32k on (2, 16, 16): the Mamba-2 blocks at model
    16 across pods, the 512-rank fake group in the CLI's own process."""
    out = tmp_path / "cell.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "zamba2-2.7b", "--shape", "decode_32k", "--multi-pod", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    cell = json.loads(out.read_text())
    assert cell["status"] == "ok" and cell["mesh"] == "2x16x16"
    assert set(cell) >= {"arch", "shape", "mesh", "family", "status",
                         "lower_s", "compile_s", "memory", "xla_cost",
                         "hlo_cost", "microbatch", "overrides", "compress"}
    mem, hlo = cell["memory"], cell["hlo_cost"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert set(hlo) >= {"flops", "hbm_bytes", "coll_bytes",
                        "coll_bytes_xpod", "coll_ops", "transcendental",
                        "matmul_flops"}
    assert hlo["matmul_flops"] > 0 and hlo["coll_bytes_xpod"] > 0
    assert hlo["coll_ops"]["all-reduce"] > 0


# ---------------------------------------------------------------- trip counts
TRIP_ARCHS = ("qwen2-1.5b", "granite-moe-1b-a400m", "falcon-mamba-7b",
              "zamba2-2.7b", "hubert-xlarge", "internvl2-76b")
TRIP_CELLS = tuple((a, k) for a in TRIP_ARCHS
                   for k in ("train", "prefill", "decode")
                   if not (a == "hubert-xlarge" and k == "decode"))

_TRIPS = textwrap.dedent("""
    import json
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.launch.mesh import Mesh, init_dry_group
    init_dry_group(8)
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    out = {}
    for arch, kind in @TRIP_CELLS@:
        shape = ShapeConfig("smoke", @S@, @B@, kind)
        out[f"{arch} {kind}"] = [measure_step(
            get_smoke_config(arch), shape, mesh,
            microbatch=2 if kind == "train" else 1, trip_counts=tc)[:2]
            for tc in (False, True)]
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def trips():
    return _run(_TRIPS.replace("@TRIP_CELLS@", repr(TRIP_CELLS)))


@pytest.mark.parametrize("key", [f"{a} {k}" for a, k in TRIP_CELLS])
def test_trip_counted_walk_books_the_full_walk(trips, key):
    """Each family's smoke train (microbatch 2), prefill and decode step at
    (2, 2, 2): the walk that runs the first layer (and microbatch) and
    books the rest gives the full walk's counts exactly, its temporaries'
    peak within 1 %, the whole step's op count within 1 %, and dispatches
    at least one op fewer per layer."""
    (full_mem, full), (mem, got) = trips[key]
    for k in ("flops", "matmul_flops", "hbm_bytes", "transcendental",
              "coll_bytes", "coll_bytes_xpod", "coll_ops", "kernels"):
        assert got[k] == full[k], (key, k, got[k], full[k])
    assert mem["argument_size_in_bytes"] == full_mem["argument_size_in_bytes"]
    assert abs(mem["temp_size_in_bytes"] / full_mem["temp_size_in_bytes"]
               - 1) <= 0.01
    assert abs(got["n_ops"] / full["n_ops"] - 1) <= 0.01
    assert full["dispatched_ops"] == full["n_ops"]
    layers = ref_smoke(key.split(" ")[0]).num_layers
    assert full["dispatched_ops"] - got["dispatched_ops"] >= layers


_TRIPS_WIDE = textwrap.dedent("""
    import dataclasses, json
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.launch.mesh import init_dry_group, make_production_mesh
    init_dry_group(512)
    mesh = make_production_mesh(multi_pod=True, device="meta")
    cfg = dataclasses.replace(get_config("deepseek-67b"), num_layers=4)
    print("RESULT " + json.dumps([measure_step(
        cfg, SHAPES["train_4k"], mesh, 1, trip_counts=tc)[:2]
        for tc in (False, True)]))
""")


def test_trip_counts_at_production_width():
    """deepseek-67b's train_4k step at full width on (2, 16, 16), cut to 4
    layers so that the full walk stays short: three layers are booked,
    two of them in backward, whose peak there (the rank's 8 rows of
    [4096, 8192] activations) the booking must place as the full walk
    does: temporaries within 0.1 %, the counts exact."""
    (full_mem, full), (mem, got) = _run(_TRIPS_WIDE)
    for k in ("flops", "matmul_flops", "hbm_bytes", "transcendental",
              "coll_bytes", "coll_bytes_xpod", "coll_ops"):
        assert got[k] == full[k], (k, got[k], full[k])
    assert abs(mem["temp_size_in_bytes"] / full_mem["temp_size_in_bytes"]
               - 1) <= 1e-3
    assert got["dispatched_ops"] < full["dispatched_ops"]


def test_former_error_cell_walks_through_the_cli(tmp_path):
    """deepseek-67b x train_4k on (2, 16, 16): 16 microbatches of 16 rows
    over 32 batch ranks (the reference's global-batch parts; a rank's own
    8 rows do not split into 16), walked to ``ok`` with trip counts."""
    out = tmp_path / "cell.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-67b", "--shape", "train_4k", "--multi-pod", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    cell = json.loads(out.read_text())
    assert cell["status"] == "ok" and cell["microbatch"] == 16
    hlo = cell["hlo_cost"]
    assert hlo["n_ops"] > 100 * hlo["dispatched_ops"]
    assert hlo["matmul_flops"] > 0


# ------------------------------------------------- the kernels' meta branch
def _kernel_calls(dev):
    """Each wrapper on the path of a step, called on ``dev`` tensors."""
    from repro_torch.kernels import (blockselect, compact, rankcount, seeds,
                                     segquery)
    from repro_torch.core.predicates import PRED_COLS
    n, F = 3000, 2
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
    keys = torch.arange(n, dtype=torch.int32, device=dev)
    w = torch.ones(n, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    objs = ((0, 0.0), (1, 1.0))
    return {
        "seeds": lambda: seeds.seeds_and_fvals(keys, w, act, objs),
        "seeds only": lambda: seeds.fused_seeds(keys, w, act, objs),
        "block_candidates": lambda: blockselect.block_candidates(
            z(F, n), 64),
        "bottomk k<n": lambda: blockselect.batched_bottomk_select(
            z(F, n), 64),
        "bottomk k>n": lambda: blockselect.batched_bottomk_select(
            z(F, 50), 64),
        "compact": lambda: compact.retention_priority(keys, w, act, act),
        "segquery": lambda: segquery.segment_query_slab(
            keys, w, w, act, z(5, PRED_COLS, dt=torch.int32), objs),
        "rankcount": lambda: rankcount.rank_counts(w, w, w, act),
    }


def test_kernel_meta_branches_give_the_plain_shapes(monkeypatch):
    """On meta tensors each wrapper gives the plain version's shapes and
    dtypes without reaching ``check_cuda`` (or running the plain version)
    and books its bytes to the recorder."""
    from repro_torch.kernels import (_util, blockselect, compact, rankcount,
                                     seeds, segquery)
    from repro_torch.launch import cost
    flat = lambda out: [t for t in (out if isinstance(out, tuple) else (out,))
                        if t is not None]
    want = {k: [(tuple(t.shape), t.dtype) for t in flat(f())]
            for k, f in _kernel_calls("cpu").items()}

    def refuse(*a, **kw):
        raise AssertionError("a meta tensor reached check_cuda")
    for mod in (_util, blockselect, compact, rankcount, seeds, segquery):
        monkeypatch.setattr(mod, "check_cuda", refuse)
    for mod, name in ((seeds, "fused_seeds_fvals_plain"),
                      (blockselect, "batched_bottomk_select_plain"),
                      (blockselect, "block_candidates_plain"),
                      (compact, "retention_priority_plain"),
                      (segquery, "segment_query_slab_plain"),
                      (rankcount, "rank_counts_plain")):
        monkeypatch.setattr(mod, name, refuse)
    with cost.recording() as rec:
        for k, f in _kernel_calls("meta").items():
            got = flat(f())
            assert all(t.device.type == "meta" for t in got), k
            assert [(tuple(t.shape), t.dtype) for t in got] == want[k], k
    assert set(rec.kernels) == {"seeds", "blockselect", "compact",
                                "segquery", "rankcount"}
    assert rec.kernels["seeds"]["calls"] == 2
    # seeds and f-values: keys, weights, active read, 2 x [2, 3000] written
    assert rec.kernels["seeds"]["bytes"] == (3000 * 9 + 2 * 2 * 3000 * 4
                                             + 3000 * 9 + 2 * 3000 * 4)
    assert rec.kernels["segquery"]["ops"] == 2 * 3000 * 5 * 2
