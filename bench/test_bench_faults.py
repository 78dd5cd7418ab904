"""A run of the train runner at smoke widths on the CPU, with its timed
path broken underneath, comes out not correct, once for each fault a
training cell can have: a step that returns its state unchanged, half of
each batch left out (the mean taken over the rest), the exchange left
out, and an answer altered where it is produced (a sampled gradient
entry's key, a step's loss). One chip has no exchange between chips; the
exchange's own sample stands in for it."""
import pytest
import torch

from bench import smoke
from bench.runners import train as R

CPU = torch.device("cpu")
SEED = 2 ** 31 + 17


def _run(name, seed=SEED):
    return R.run(smoke.cell(name), seed=seed, seconds=0.5, trace=False,
                 device=CPU, t_start=0.0)


def _broken_step(monkeypatch, wrap):
    from repro_torch.launch import steps as St
    make = St.make_train_step

    def made(*a, **kw):
        step, specs = make(*a, **kw)
        return wrap(step), specs
    monkeypatch.setattr(St, "make_train_step", made)


def test_fault_state_unchanged(monkeypatch):
    def wrap(step):
        def frozen(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return frozen
    _broken_step(monkeypatch, wrap)
    out = _run("granite-moe-1b-a400m.train_4k")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m.train_4k",
                                  "zamba2-2.7b.train_4k"])
def test_fault_half_the_batch(monkeypatch, name):
    def wrap(step):
        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            # each part's first half, repeated: the mean over the rest
            idx = torch.arange(batch["tokens"].shape[0]) % n
            return step(state, {"tokens": batch["tokens"][idx]})
        return half
    _broken_step(monkeypatch, wrap)
    assert not _run(name)["correct"]


def test_fault_exchange_left_out(monkeypatch):
    from repro_torch.distopt import compression as CP
    monkeypatch.setattr(CP, "compressed_grads_fn",
                        lambda *a, **kw: None)
    out = _run("granite-moe-1b-a400m.train_4k")
    assert not out["correct"]
    assert out["checks"]["sample_miss"]["value"] > 0


def test_fault_sampled_key_altered(monkeypatch):
    from repro_torch.distopt import compression as CP
    orig = CP._sample_leaf

    def altered(*a, **kw):
        sk = orig(*a, **kw)
        keys = sk.keys.clone()
        keys[0] = (keys[0] + 1) % a[0].numel()
        return sk._replace(keys=keys)
    monkeypatch.setattr(CP, "_sample_leaf", altered)
    out = _run("granite-moe-1b-a400m.train_4k")
    assert not out["correct"]
    assert out["checks"]["sample_miss"]["value"] >= 1


def test_fault_loss_altered(monkeypatch):
    def wrap(step):
        def off(state, batch):
            new, metrics = step(state, batch)
            return new, dict(metrics, loss=metrics["loss"] * 1.05)
        return off
    _broken_step(monkeypatch, wrap)
    out = _run("granite-moe-1b-a400m.train_4k-dense")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > 0.04


def test_fault_telemetry_key_altered(monkeypatch):
    """The step's telemetry sketch loses a row's key where the fold
    produces it: the sketch's key check counts it."""
    def wrap(step):
        def off(state, batch):
            new, metrics = step(state, batch)
            tel = new["tel"]
            first = int(tel.valid.nonzero()[0])
            keys = tel.keys.clone()
            keys[first] += 1 << 15
            return dict(new, tel=tel._replace(keys=keys)), metrics
        return off
    _broken_step(monkeypatch, wrap)
    out = _run("granite-moe-1b-a400m.train_4k-dense")
    assert not out["correct"]
    assert out["checks"]["tel_miss"]["value"] >= 1


@pytest.mark.parametrize("keys,miss", [
    ([0, 1, 65536, 65537], 0),
    ([0, 65536, 65537], 1),                 # a row's key missing
    ([0, 1, 65536, 65537, 2], 1),           # a key that no row has
    ([0, 0, 65536, 65537], 2),              # one key twice, one missing
])
def test_tel_miss_counts_the_keys_that_differ(keys, miss):
    from bench import check as Chk
    assert Chk.tel_miss(keys, steps=2, rows=2) == miss
