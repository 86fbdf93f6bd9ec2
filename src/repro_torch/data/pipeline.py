"""Deterministic synthetic data pipeline (the port's copy of
``repro/data/pipeline.py``, on the port's ``ModelConfig``; numpy, so its
batches are the reference's bit for bit): sharded, packed, prefetched.

Production shape without external deps: a counter-based PRNG stream (every
(seed, step, host_shard) triple maps to the same batch on every run and any
host count — elastic restarts keep the data order), document packing with
EOS boundaries, and a background prefetch thread that overlaps host data
generation with device compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8  # per-host batch
    seq_len: int = 128
    vocab_size: int = 512
    num_hosts: int = 1
    host_id: int = 0
    mean_doc_len: int = 64
    prefetch: int = 2


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    # counter-based: independent stream per (seed, step, host)
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id, cfg.num_hosts]))


def synth_batch(cfg: DataConfig, mcfg: ModelConfig, step: int) -> dict:
    """Packed-LM batch: documents of geometric length joined by EOS=0; labels
    are next-token targets. Multimodal frontends get synthetic embeddings."""
    rng = _rng_for(cfg, step)
    b, s, v = cfg.batch, cfg.seq_len, min(cfg.vocab_size, mcfg.vocab_size)
    toks = np.zeros((b, s + 1), np.int32)
    for i in range(b):
        pos = 0
        while pos < s + 1:
            dl = int(rng.geometric(1.0 / cfg.mean_doc_len))
            dl = max(2, min(dl, s + 1 - pos))
            toks[i, pos:pos + dl - 1] = rng.integers(1, v, dl - 1)
            # EOS terminates the doc (token 0)
            pos += dl
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if mcfg.frontend == "vit-stub":
        batch["patch_embeds"] = rng.standard_normal(
            (b, mcfg.frontend_len, mcfg.frontend_dim)).astype(np.float32)
        lab = np.concatenate(
            [np.full((b, mcfg.frontend_len), -1, np.int32), batch["labels"]], axis=1)
        batch["labels"] = lab  # -1 = masked positions (vision prefix)
    if mcfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, s, mcfg.frontend_dim)).astype(np.float32)
    return batch


class PrefetchingLoader:
    """Background-thread prefetch of synth batches (overlaps host-side data
    generation with device compute)."""

    def __init__(self, cfg: DataConfig, mcfg: ModelConfig, start_step: int = 0):
        self.cfg, self.mcfg = cfg, mcfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.mcfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
