"""Deterministic, restartable, host-sharded data pipelines (a copy of the
JAX package's ``repro.data.pipeline``: the same arrays, bit for bit, for the
same seed and step; numpy only, the train driver moves them to the device).

Design constraints for 1000+ node training:
  * Deterministic as a function of (seed, step) — any host can reproduce any
    step's batch, which is what makes elastic restarts and straggler
    re-dispatch correct: there is no iterator state to lose, the "cursor" is
    just the step counter saved in the checkpoint.
  * Host-sharded: each host materializes only its slice of the global batch
    (`host_slice(step, host_id, num_hosts)`).
  * Two sources: a synthetic stream (seeded PRNG; zipf-ish token marginals so
    losses are non-degenerate) and a memory-mapped binary token file packed
    into fixed-length sequences.

LatentPipeline produces (latents, class labels, noise, t) batches for
diffusion training — the DiT path of the paper.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | file
    path: Optional[str] = None


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.source == "file":
            assert cfg.path, "file source needs a path"
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")
            self._n_seqs = len(self._mm) // (cfg.seq_len + 1)
            assert self._n_seqs > 0, "token file smaller than one sequence"

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row]))

    def _synthetic_row(self, step: int, row: int) -> np.ndarray:
        rng = self._rng(step, row)
        # zipf-flavored marginals over the vocab, cheap + non-degenerate
        z = rng.zipf(1.3, size=self.cfg.seq_len + 1)
        return np.minimum(z - 1, self.cfg.vocab_size - 1).astype(np.int32)

    def _file_row(self, step: int, row: int) -> np.ndarray:
        idx = (step * self.cfg.global_batch + row) % self._n_seqs
        s = idx * (self.cfg.seq_len + 1)
        return np.asarray(self._mm[s : s + self.cfg.seq_len + 1], np.int32)

    def batch(self, step: int, rows: Optional[range] = None):
        """Batch for `step`; `rows` selects a host's slice of the global
        batch (default: all rows)."""
        rows = rows if rows is not None else range(self.cfg.global_batch)
        fn = self._file_row if self._mm is not None else self._synthetic_row
        seqs = np.stack([fn(step, r) for r in rows])
        return {"inputs": seqs[:, :-1], "labels": seqs[:, 1:]}

    def host_slice(self, step: int, host_id: int, num_hosts: int):
        per = self.cfg.global_batch // num_hosts
        return self.batch(step, range(host_id * per, (host_id + 1) * per))


class LatentPipeline:
    """Diffusion-training batches over a fixed synthetic latent dataset —
    a mixture of class-conditional Gaussians, so a small DiT genuinely learns
    class-dependent structure (used by the paper-claims experiments)."""

    def __init__(self, num_tokens: int, latent_dim: int, num_classes: int,
                 n_train_timesteps: int = 1000, seed: int = 0,
                 dataset_size: int = 256):
        self.n_tok, self.dim, self.n_cls = num_tokens, latent_dim, num_classes
        self.n_t = n_train_timesteps
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.class_means = rng.normal(size=(num_classes, num_tokens, latent_dim)).astype(np.float32)
        self.dataset = rng.normal(size=(dataset_size, num_tokens, latent_dim)).astype(np.float32) * 0.3
        self.dataset_labels = rng.integers(0, num_classes, size=dataset_size)
        self.dataset += self.class_means[self.dataset_labels]

    def batch(self, step: int, batch_size: int):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 7, step]))
        idx = rng.integers(0, len(self.dataset), size=batch_size)
        return {
            "latents": self.dataset[idx],
            "labels": self.dataset_labels[idx].astype(np.int32),
            "noise": rng.normal(size=(batch_size, self.n_tok, self.dim)).astype(np.float32),
            "t": rng.integers(0, self.n_t, size=batch_size).astype(np.int32),
        }
