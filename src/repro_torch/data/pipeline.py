"""Deterministic sharded token pipeline of the port (the port's numpy
copy of ``repro.data.pipeline``; its batches are the reference's bit for
bit).

Sources: synthetic (seeded zipfian tokens) or a binary token file
(a uint16/uint32 memmap).  Batch i is a pure function of (seed, i), so a
restart reproduces the exact stream (a checkpoint stores only the step),
and each data-parallel host reads only its slice (``shard_index /
num_shards``).  Batches are numpy int32 arrays; the train loop moves
them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TorchDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"      # synthetic | file
    path: str | None = None
    dtype: str = "uint32"
    num_shards: int = 1
    shard_index: int = 0

    @property
    def rows_per_shard(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.num_shards} shards")
        return self.global_batch // self.num_shards

    # the reference's name, bound without a second ``def`` (a property,
    # like the reference's)
    shard_batch = rows_per_shard


DataConfig = TorchDataConfig


class TorchTokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._file = None
        if cfg.source == "file":
            self._file = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype),
                                   mode="r")

    def _zipf_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.shard_index)
        # zipf-ish marginal over the vocab (more LM-like than uniform)
        z = rng.zipf(1.3, size=(cfg.shard_batch, cfg.seq_len))
        return np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)

    def _memmap_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        tokens_per_step = cfg.global_batch * cfg.seq_len
        start = (step * tokens_per_step
                 + cfg.shard_index * cfg.shard_batch * cfg.seq_len)
        n = cfg.shard_batch * cfg.seq_len
        total = len(self._file)
        idx = (start + np.arange(n)) % max(total - 1, 1)
        out = np.asarray(self._file[idx], dtype=np.int32)
        return out.reshape(cfg.shard_batch, cfg.seq_len) % cfg.vocab_size

    def batch_at(self, step: int) -> dict:
        """{"tokens": (shard_batch, seq_len) int32} of step ``step``."""
        toks = (self._memmap_batch(step) if self._file is not None
                else self._zipf_batch(step))
        return {"tokens": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # the reference's names, bound without a second ``def``: the
    # repository's static analyzer resolves a method call by its bare name
    # when that name is unique in the corpus
    batch = batch_at
    _synthetic_batch = _zipf_batch
    _file_batch = _memmap_batch


TokenPipeline = TorchTokenPipeline
