"""Data pipeline: deterministic synthetic corpus + multi-objective
importance sampling.

Port of ``repro/data/pipeline.py``. The corpus and the batches come from
the reference's numpy generators, call for call, so tokens, weights and
batches are bit-identical to the reference's. Any worker can recompute the
batch of any (step, shard) from the seed alone: no loader state to
checkpoint.

Importance sampling: one MULTI-OBJECTIVE summary (``MultiSketch``,
F = {(sum, k), (count, k)}) over the corpus's quality weights is both an
importance-sampled replay pool (draw x with p ∝ p_x^(F), reweight by HT
1/p_x) and a sketch that estimates f-statistics of any key segment of the
whole corpus. It is built once on ``device`` (default: the card), through
K1-K3.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (COUNT, SUM, MultiSketchSpec, multisketch_build,
                              sketch_estimate)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_docs: int = 100_000
    n_domains: int = 16
    seed: int = 0


class SyntheticCorpus:
    """Deterministic keyed corpus: doc id -> (tokens, domain, weight)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.domain = rng.integers(0, cfg.n_domains, cfg.n_docs)
        # per-domain lognormal quality weights (heavy-tailed)
        dom_mu = rng.normal(0, 1, cfg.n_domains)
        self.weights = np.exp(
            dom_mu[self.domain] + 0.8 * rng.standard_normal(cfg.n_docs)
        ).astype(np.float32)

    def tokens(self, doc_ids, length):
        """Deterministic tokens per doc (zipf-ish), stateless."""
        cfg = self.cfg
        out = np.empty((len(doc_ids), length), np.int32)
        for i, d in enumerate(np.asarray(doc_ids)):
            rng = np.random.default_rng(cfg.seed * 1_000_003 + int(d))
            z = rng.zipf(1.3, size=length).astype(np.int64)
            out[i] = (z % (cfg.vocab_size - 1)) + 1
        return out


class Loader:
    """Step-indexed batch generator. batch(step) is a pure function of
    (seed, step), identical on every rank."""

    def __init__(self, corpus: SyntheticCorpus, cfg: DataConfig,
                 importance: bool = False, k: int = 256, device=None):
        self.corpus = corpus
        self.cfg = cfg
        self.importance = importance
        if importance:
            keys = np.arange(cfg.n_docs, dtype=np.int32)
            active = np.ones(cfg.n_docs, bool)
            # (sum, k) drives the importance draws, (count, k) keeps
            # support/threshold queries sharp (Thm 3.1 dominance)
            self.spec = MultiSketchSpec(
                objectives=((SUM, k), (COUNT, k)), seed=cfg.seed)
            self.sketch = multisketch_build(self.spec, keys, corpus.weights,
                                            active,
                                            device=resolve_device(device))
            member = self.sketch.member.cpu().numpy()
            self.pool = self.sketch.keys.cpu().numpy()[member]
            self.pool_p = self.sketch.probs.cpu().numpy()[member]
            # draw ∝ p within the sample ≈ weighted replay; HT weight 1/p
            self.pool_draw = self.pool_p / self.pool_p.sum()

    def batch(self, step: int):
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        if self.importance:
            idx = rng.choice(len(self.pool), cfg.global_batch, replace=True,
                             p=self.pool_draw)
            docs = self.pool[idx]
        else:
            docs = rng.integers(0, cfg.n_docs, cfg.global_batch)
        toks = self.corpus.tokens(docs, cfg.seq_len)
        return {"tokens": toks, "docs": docs}

    def corpus_stats(self, f, segment_domain=None):
        """Exact segment f-statistic over the full corpus (validation)."""
        w = torch.from_numpy(self.corpus.weights)
        sel = (torch.ones_like(w, dtype=torch.bool) if segment_domain is None
               else torch.from_numpy(self.corpus.domain == segment_domain))
        return float(torch.sum(f(w) * sel))

    def sketch_stats(self, f, segment_domain=None):
        """Estimated segment f-statistic from the importance sketch alone
        (what a worker answers WITHOUT touching the full corpus)."""
        if not self.importance:
            raise ValueError("sketch_stats needs importance=True")
        dev = self.sketch.keys.device
        domain = torch.from_numpy(self.corpus.domain).to(dev)
        seg = (None if segment_domain is None
               else lambda k: domain[torch.clamp_min(k, 0).to(torch.int64)]
               == segment_domain)
        return float(sketch_estimate(self.sketch, f, seg))
