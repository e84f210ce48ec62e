"""Data pipeline: deterministic synthetic LM data + file-backed token
streams, host-side prefetch.

``DataConfig``, ``SyntheticLM``, ``FileTokens`` and ``make_source`` are
copies of the reference's: numpy only, so one seed gives the same batches
in both packages. ``Prefetcher`` moves each batch to the port's device
(the reference's ``jax.device_put`` with a sharding) while the previous
step runs.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    path: Optional[str] = None      # .npy token file (memory-mapped) or None
    prefetch: int = 2


class SyntheticLM:
    """Deterministic pseudo-corpus: a fixed-seed Zipfian token stream with
    local n-gram structure so the loss actually decreases (unlike uniform
    noise), cheap enough to generate on the fly."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        # a sticky bigram table: each token prefers a few successors
        self.succ = rng.randint(0, v, size=(min(v, 4096), 4))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.RandomState(cfg.seed + 1 + step)
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self.probs)
        follow = rng.rand(b, s) < 0.7
        rand_next = rng.choice(cfg.vocab_size, size=(b, s), p=self.probs)
        pick = rng.randint(0, 4, size=(b, s))
        for t in range(s):
            prev = toks[:, t] % self.succ.shape[0]
            toks[:, t + 1] = np.where(follow[:, t],
                                      self.succ[prev, pick[:, t]],
                                      rand_next[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FileTokens:
    """Memory-mapped token file -> fixed-length training windows."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.load(cfg.path, mmap_mode="r")

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        n = (len(self.tokens) - 1) // s
        rng = np.random.RandomState(cfg.seed + step)
        idx = rng.randint(0, n, size=b)
        toks = np.stack([self.tokens[i * s:i * s + s + 1] for i in idx])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def to_device(batch: dict, device) -> dict:
    """A numpy batch as int32 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """Host-side lookahead thread: generate/load batch k+1 while step k runs
    (the paper's decoupled operand fetch, at the pipeline level). With a
    ``device``, each batch arrives there as tensors."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 device=None):
        self.source = source
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        while not self.stop.is_set():
            batch = self.source.batch(self.step)
            if self.device is not None:
                batch = to_device(batch, self.device)
            try:
                self.q.put((self.step, batch), timeout=1.0)
                self.step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        while True:
            yield self.q.get()

    def close(self, timeout: float = 5.0):
        """Stop the thread and wait for it (it checks ``stop`` at least
        once a second)."""
        self.stop.set()
        self.thread.join(timeout)


def make_source(cfg: DataConfig):
    return FileTokens(cfg) if cfg.path else SyntheticLM(cfg)
