"""Deterministic token data pipeline: synthetic LM stream + memmap corpus
(a copy of ``repro.data.pipeline``, which the port may not import; it
holds numpy arrays, and the trainer moves each batch to its device).

Production shape: an indexable shard-aware source (the JAX package's
host-side prefetch queue is left out: no caller of the port uses it).
Every batch is reproducible from (seed, step) alone, which is what
makes checkpoint/restart and elastic re-sharding exact: a restarted (and
possibly re-sized) job replays the identical global batch sequence.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: str | None = None   # memmap'd uint16/uint32 token file


class TokenSource:
    """Deterministic (seed, step) -> global batch of (tokens, labels)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._corpus = None
        if cfg.corpus_path:
            self._corpus = np.memmap(cfg.corpus_path, dtype=np.uint16, mode="r")

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        if self._corpus is not None:
            n = len(self._corpus) - cfg.seq_len - 1
            starts = rng.integers(0, n, size=cfg.global_batch)
            toks = np.stack([self._corpus[s: s + cfg.seq_len + 1] for s in starts])
            toks = toks.astype(np.int32)
        else:
            # synthetic: markov-ish stream so the loss is learnable
            base = rng.integers(0, cfg.vocab_size,
                                size=(cfg.global_batch, cfg.seq_len + 1))
            drift = np.cumsum(rng.integers(0, 3, size=base.shape), axis=1)
            toks = ((base + drift) % cfg.vocab_size).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_batch(self, step: int, shard: int, num_shards: int) -> dict[str, np.ndarray]:
        """This host's slice of the global batch (data-parallel sharding)."""
        g = self.global_batch(step)
        per = self.cfg.global_batch // num_shards
        sl = slice(shard * per, (shard + 1) * per)
        return {k: v[sl] for k, v in g.items()}
