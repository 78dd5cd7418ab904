"""The benchmark's own weights: every parameter leaf drawn from the run's
seed on the device, one generator and one call per leaf, in float32.

Both the program and the plain reference take their weights from here, so
neither takes weights the other made. A leaf is named by its dotted path
and drawn by the rule for its last name, as the published models
initialise such a leaf:

  * matrices (``w*``, ``router``, ``out_proj``, ``tok``, ``out``): a normal
    truncated to two standard deviations, scaled by 1/sqrt(fan-in) (the
    fan-in is the second-to-last dim, the output embedding's its last;
    the token embedding has scale 1);
  * norm scales and ``D``: ones; biases: zeros;
  * depthwise conv taps: normal, scale 0.1;
  * Mamba-2 ``A_log``: log U(1, 16); ``dt_bias``: the inverse softplus of
    a log-uniform dt in [1e-3, 1e-1].

Leaf i of a run with seed s is drawn from its own generator seeded with
(s * 1,000,003 + 7919 * (i + 1)) mod 2^63, so the reference can draw any
one leaf again without the others.
"""
from __future__ import annotations

import math

import torch

_ONES = ("scale", "norm_scale", "D")
_ZEROS = ("bias", "conv_b", "conv_xb", "conv_Bb", "conv_Cb")
_CONV = ("conv_w", "conv_x", "conv_B", "conv_C")


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


def draw_leaf(path: str, shape, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` (its place in sorted-path order) of the run's
    weights, float32 on ``device``."""
    name = path.rsplit(".", 1)[-1]
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if name in _ONES:
        return t.fill_(1.0)
    if name in _ZEROS:
        return t.fill_(0.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    if name in _CONV:
        return t.normal_(generator=gen).mul_(0.1)
    if name == "A_log":
        return t.uniform_(1.0, 16.0, generator=gen).log_()
    if name == "dt_bias":
        t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
        return t.exp_().expm1_().log_()
    if len(shape) < 2:
        raise ValueError(f"no draw rule for the 1-D leaf {path!r}")
    if path == "emb.tok":
        scale = 1.0
    elif path == "emb.out":                  # [vocab, d]: fan-in is d
        scale = 1.0 / math.sqrt(shape[-1])
    else:
        scale = 1.0 / math.sqrt(shape[-2])
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def draw_all(shapes: dict, seed: int, device) -> dict:
    """{path: leaf} for {path: shape}, the paths in sorted order."""
    return {p: draw_leaf(p, shapes[p], seed, i, device)
            for i, p in enumerate(sorted(shapes))}
