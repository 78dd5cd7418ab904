"""The FLOP and byte formulas of the per-layer metrics against values
worked out by hand, and the trace arithmetic on a made-up trace."""
import types

import pytest

from bench import harness as H
from bench import smoke
from bench.trace import Trace

MFU = H.metric("train_mfu")
XB = H.load_module(H.BENCH / "metrics" / "exchange_bytes.py", "xb_test")


def _run(name):
    cell = smoke.full(name)
    from bench.runners import train as R
    rows = R.rows_of(cell)
    shapes = _shapes(cell.config["model"])
    return types.SimpleNamespace(cell=cell, shapes=shapes,
                                 tokens_per_step=rows * 4096)


def _shapes(m):
    """The port's parameter shapes, by hand."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    Vp = -(-V // 128) * 128
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    attn = {"attn.wq": (d, q), "attn.wk": (d, kv), "attn.wv": (d, kv),
            "attn.wo": (q, d), "ln1.scale": (d,), "ln2.scale": (d,)}
    out = {"emb.tok": (Vp, d), "ln_f.scale": (d,)}
    if m["family"] == "moe":
        E, f = m["num_experts"], m["d_ff"]
        layer = dict(attn, **{"moe.router": (d, E), "moe.wi": (E, d, f),
                              "moe.wg": (E, d, f), "moe.wo": (E, f, d)})
        out.update({f"layers.{k}": (L, *s) for k, s in layer.items()})
        return out
    di, N = 2 * d, m["ssm_state"]
    H_ = di // m["ssm_head_dim"]
    out["emb.out"] = (Vp, d)
    mamba = {"wz": (d, di), "wx": (d, di), "wB": (d, N), "wC": (d, N),
             "wdt": (d, H_), "conv_x": (di, 4), "conv_xb": (di,),
             "conv_B": (N, 4), "conv_Bb": (N,), "conv_C": (N, 4),
             "conv_Cb": (N,), "A_log": (H_,), "dt_bias": (H_,), "D": (H_,),
             "norm_scale": (di,), "out_proj": (di, d)}
    out.update({f"layers.mamba.{k}": (L, *s) for k, s in mamba.items()})
    out["layers.ln1.scale"] = (L, d)
    f = m["d_ff"]
    shared = dict(attn, **{"mlp.wi": (d, f), "mlp.wg": (d, f),
                           "mlp.wo": (f, d)})
    out.update({f"shared.{k}": s for k, s in shared.items()})
    return out


def test_granite_flops_by_hand():
    m = _run("granite-moe-1b-a400m.train_4k").cell.config["model"]
    # per layer: attention 3,145,728 + router 32,768 + 8 experts
    # 12,582,912 = 15,761,408; x 24 + head 50,334,720 = 428,608,512
    per_token = 6 * 428_608_512 + 6 * 4096 * 1024 * 24
    assert MFU.token_flops(m, 4096) == per_token == 3_175_630_848
    assert MFU.step_flops(m, 8, 4096) == per_token * 32_768


def test_zamba2_flops_by_hand():
    m = _run("zamba2-2.7b.train_4k").cell.config["model"]
    # Mamba-2 per layer 39,854,080 x 54; shared block 104,857,600 x 9;
    # head 81,920,000: 3,177,758,720 matrix parameters
    mats = 39_854_080 * 54 + 104_857_600 * 9 + 81_920_000
    attn = 6 * 4096 * 2560 * 9
    ssd = 3 * 54 * (256 * (64 + 5120) + 4 * 64 * 5120)
    assert mats == 3_177_758_720
    assert MFU.token_flops(m, 4096) == 6 * mats + attn + ssd


def test_mfu_of_a_made_up_window():
    run = _run("granite-moe-1b-a400m.train_4k")
    run.device_name = "NVIDIA H100 80GB HBM3"
    # two untraced steps of 2 s each, one traced step left out
    run.spans = [(0, 0.1, 1.0, 2.0, False), (2, 2.1, 3, 4.0, False),
                 (4, 4.1, 5, 9.0, True)]
    flops = 3_175_630_848 * 32_768
    assert MFU.read(run) == pytest.approx(100 * flops / 2.0 / 989e12)
    run.device_name = "a card not in the table"
    assert MFU.read(run) is None


@pytest.mark.parametrize("name,leaves,rows", [
    ("granite-moe-1b-a400m.train_4k", 9, 8),
    ("zamba2-2.7b.train_4k", 19, 2)])
def test_exchange_bytes_by_hand(name, leaves, rows):
    run = _run(name)
    sizes = XB.sampled(run)
    assert len(sizes) == leaves
    nf = 196 + rows
    b1, n1 = XB.per_step(run, "k1")
    assert n1 == leaves + 1
    assert b1 == 21 * sum(sizes) + 33 * nf
    b2, n2 = XB.per_step(run, "k2")
    assert n2 == leaves + 2
    assert b2 == sum(12 * n + 6180 for n in sizes) \
        + 12 * nf + 1572 + 4 * nf + 1572


def test_the_largest_sampled_leaves():
    g = XB.sampled(_run("granite-moe-1b-a400m.train_4k"))
    z = XB.sampled(_run("zamba2-2.7b.train_4k"))
    assert max(g) == 24 * 32 * 1024 * 512 == 402_653_184
    assert max(z) == 54 * 2560 * 5120 == 707_788_800
    # emb.tok 50,462,720 + wq, wo 2 x 25,165,824 + wk, wv 2 x 12,582,912
    # + router 786,432 + wi, wg, wo 3 x 402,653,184
    assert sum(g) == 1_334_706_176


def test_dense_cell_has_no_exchange_bytes():
    run = _run("granite-moe-1b-a400m.train_4k-dense")
    assert XB.sampled(run) == []
    run.trace = Trace([], [("bench.loader", 0, 1)], 1)
    run.device_name = "NVIDIA H100 80GB HBM3"
    assert XB.roofline(run, "k1", "seeds") is None


def test_trace_busy_idle_and_gaps():
    spans = [("bench.loader", 0.0, 1.0), ("bench.step_call", 1.0, 3.0),
             ("bench.sync", 3.0, 4.0)]
    dev = [("seeds_kernel", 1.5, 2.0), ("gemm", 1.8, 2.5),
           ("select_hist_kernel", 3.0, 3.5), ("outside", 5.0, 6.0)]
    tr = Trace(dev, spans, 1)
    assert tr.window == (0.0, 4.0)
    assert tr.window_s() == 4.0
    assert tr.busy() == [[1.5, 2.5], [3.0, 3.5]]
    # every operation the profiler holds is the traced steps': busy_s
    # keeps the one a clock offset put outside the host's window
    assert tr.busy_s() == pytest.approx(2.5)
    assert tr.outside_s() == pytest.approx(1.0)
    assert tr.kernel_time(lambda n: "select_" in n) == (0.5, 1)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert gaps["loader"] == pytest.approx(1.0)
    assert gaps["step_call"] == pytest.approx(1.0)
    assert gaps["sync"] == pytest.approx(0.5)
    assert tr.top_ops(2)[0][0] == "outside"


IDLE = H.metric("idle_share.train")


def test_idle_share_holds_the_traced_busy_time_to_an_untraced_step():
    """The device's busy seconds per traced step against the mean wall of
    the untraced steps: the profiler's slower traced steps (here 5 s and
    6 s) do not count as the device's wait."""
    tr = Trace([("gemm", 10.0, 11.0), ("gemm", 11.2, 12.8),
                ("exp", 15.0, 16.4)], [("bench.loader", 10.0, 21.0)], 2)
    run = types.SimpleNamespace(trace=tr, spans=[
        (0, 0.01, 1.5, 1.9, False), (2, 2.01, 3.9, 4.1, False),
        (10, 10.01, 14.9, 15.0, True), (15, 15.01, 20.9, 21.0, True)])
    # busy 4.0 s over 2 traced steps: 2.0 s a step, against 2.0 s walls
    assert IDLE.read(run) == pytest.approx(0.0)
    run.spans[1] = (2, 2.01, 3.9, 4.5, False)
    assert IDLE.read(run) == pytest.approx(100 * (1 - 2.0 / 2.2))


@pytest.mark.parametrize("case", ["no_trace", "no_device_ops",
                                  "no_untraced_step"])
def test_idle_share_is_silent_without_its_readings(case):
    tr = Trace([] if case == "no_device_ops" else [("gemm", 0.0, 1.0)],
               [("bench.loader", 0.0, 2.0)], 1)
    spans = [(0, 0.1, 1.0, 2.0, True)]
    if case != "no_untraced_step":
        spans.append((2, 2.1, 3.0, 4.0, False))
    run = types.SimpleNamespace(trace=None if case == "no_trace" else tr,
                                spans=spans)
    assert IDLE.read(run) is None


def test_host_span_readers():
    run = types.SimpleNamespace(spans=[(0, 0.01, 0.5, 2.0, False),
                                       (2, 2.03, 2.7, 4.0, False),
                                       (4, 4.5, 5.0, 9.0, True)],
                                window_peak_bytes=3 * 2 ** 30)
    assert H.metric("loader_ms.train").read(run) == pytest.approx(20.0)
    assert H.metric("dispatch_ms.train").read(run) == pytest.approx(580.0)
    assert H.metric("peak_hbm_gib.train").read(run) == pytest.approx(3.0)
