"""Deterministic synthetic token pipeline with sharding + replay support
(port of ``repro/data/pipeline.py``; numpy, as there).

An infinite stream of packed LM batches that is
  * deterministic in (seed, step) — restart/recovery replays the exact
    stream from a checkpointed step with no state beyond the step counter
    (the fault-tolerance contract of ``launch/train.py``);
  * shardable — each data-parallel host generates only its slice
    (host_batch = global_batch / dp_shards), keyed by (seed, step, shard);
  * structured, not uniform noise — a tiny hidden-Markov "language" so the
    loss actually decreases.

Batches are numpy arrays, equal byte for byte to the JAX package's for
every (seed, step, shard); the caller moves them to its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.frontends import token_len


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    n_states: int = 32          # HMM states
    branch: int = 4             # candidate next-tokens per state


def _hmm_tables(cfg: DataConfig, vocab: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    emit = rng.integers(0, vocab, size=(cfg.n_states, cfg.branch))
    trans = rng.integers(0, cfg.n_states, size=(cfg.n_states, cfg.branch))
    return emit.astype(np.int64), trans.astype(np.int64)


def sample_tokens(cfg: DataConfig, vocab: int, batch: int, seq: int,
                  step: int, shard: int = 0) -> np.ndarray:
    """[batch, seq+1] int32 tokens, deterministic in (seed, step, shard)."""
    emit, trans = _hmm_tables(cfg, vocab)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    state = rng.integers(0, cfg.n_states, size=batch)
    out = np.empty((batch, seq + 1), np.int64)
    choices = rng.integers(0, cfg.branch, size=(seq + 1, batch))
    for t in range(seq + 1):
        c = choices[t]
        out[:, t] = emit[state, c]
        state = trans[state, c]
    return out.astype(np.int32) % vocab


def make_train_batch(arch: ArchConfig, shape: ShapeConfig, dcfg: DataConfig,
                     step: int, shard: int = 0,
                     n_shards: int = 1) -> dict:
    """One host-local training batch (numpy; the caller moves it)."""
    b = shape.global_batch // n_shards
    s = shape.seq_len
    tl = token_len(arch, s)
    toks = sample_tokens(dcfg, arch.vocab, b, s, step, shard)
    batch = {
        "tokens": toks[:, :tl],
        "targets": toks[:, 1:s + 1],
        "loss_mask": np.ones((b, s), np.float32),
    }
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed + 1, step, shard]))
    if arch.frontend == "vision":
        batch["embeds"] = (rng.standard_normal(
            (b, arch.n_frontend_embeds, arch.d_model)) * 0.02
        ).astype(np.float32)
        batch["loss_mask"][:, :arch.n_frontend_embeds] = 0.0
    if arch.is_encdec:
        batch["enc_embeds"] = (rng.standard_normal(
            (b, s, arch.d_model)) * 0.02).astype(np.float32)
        batch["tokens"] = toks[:, :s]
    return batch


class DataIterator:
    """Stateless-resumable iterator over the deterministic stream."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 dcfg: DataConfig | None = None, start_step: int = 0,
                 shard: int = 0, n_shards: int = 1):
        self.arch, self.shape = arch, shape
        self.dcfg = dcfg or DataConfig()
        self.step = start_step
        self.shard, self.n_shards = shard, n_shards

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = make_train_batch(self.arch, self.shape, self.dcfg, self.step,
                             self.shard, self.n_shards)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step, "seed": self.dcfg.seed}
