"""Synthetic LM data pipeline: deterministic, shardable, restart-safe (a
copy of ``repro.training.data``, numpy only).

Batches are a pure function of (seed, step), so a restarted trainer resumes
from the checkpointed step with bit-identical data, and the batches equal
the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 1234
    # synthetic structure: token n+1 depends on token n (learnable signal)
    vocab_cap: int = 0  # 0 => cfg.vocab_size


class SyntheticDataset:
    """Markov-ish synthetic tokens: learnable but trivial to generate."""

    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig):
        self.cfg = cfg
        self.dcfg = data_cfg
        self.vocab = data_cfg.vocab_cap or cfg.vocab_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        d = self.dcfg
        rng = np.random.default_rng((d.seed, step))
        b, s = d.global_batch, d.seq_len
        starts = rng.integers(0, self.vocab, size=(b, 1))
        deltas = rng.integers(1, 7, size=(b, s))
        toks = (starts + np.cumsum(deltas, axis=1)) % self.vocab
        toks = toks.astype(np.int32)
        inputs = toks[:, :-1] if s > 1 else toks
        labels = toks[:, 1:] if s > 1 else toks
        # keep shapes (b, s): pad one position with ignore-label -100
        inputs = np.concatenate([inputs, inputs[:, -1:]], axis=1)
        labels = np.concatenate([labels, np.full((b, 1), -100, np.int32)], axis=1)
        if self.cfg.is_encdec:
            half = s // 2
            return dict(
                src=rng.standard_normal((b, half, self.cfg.d_model)).astype(np.float32),
                tgt=inputs[:, :half],
                labels=labels[:, :half],
            )
        if self.cfg.input_mode == "embeddings":
            return dict(
                inputs=rng.standard_normal((b, s, self.cfg.d_model)).astype(np.float32),
                labels=labels,
            )
        return dict(inputs=inputs, labels=labels)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
