"""Deterministic synthetic LM data pipeline (a copy of
``repro/data/synthetic.py``, which is numpy only: the same seed gives the
same batches as the reference's ``make_batch_iterator``).

A real tokenized-corpus loader is out of scope for a CPU container (the paper
trains on pre-tokenized text), but the pipeline *shape* is real: a document
source, sequence packing with EOS separators, host-sharded global batches,
and background prefetch — the pieces a cluster deployment needs.

The corpus is a Zipf-distributed, Markov-flavoured token stream so the loss
actually decreases when models train on it (structure to learn), fully
deterministic in (seed, document index).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    mean_doc_len: int = 512
    zipf_a: float = 1.2
    eos_id: int = 0

    def document(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, idx]))
        length = max(8, int(rng.poisson(self.mean_doc_len)))
        # zipfian unigram base
        base = rng.zipf(self.zipf_a, size=length).astype(np.int64)
        base = (base - 1) % max(self.vocab_size - 2, 1) + 1
        # markov flavour: with p=0.5 repeat (prev*7+3) mod V — learnable bigrams
        toks = base.copy()
        flips = rng.random(length) < 0.5
        for i in range(1, length):
            if flips[i]:
                toks[i] = (toks[i - 1] * 7 + 3) % (self.vocab_size - 1) + 1
        return toks.astype(np.int32)

    def packed_sequences(self, seq_len: int, start_doc: int = 0) -> Iterator[np.ndarray]:
        """Packs documents into fixed-length sequences with EOS separators."""
        buf: list[int] = []
        doc = start_doc
        while True:
            while len(buf) < seq_len:
                buf.extend(self.document(doc).tolist())
                buf.append(self.eos_id)
                doc += 1
            yield np.asarray(buf[:seq_len], np.int32)
            buf = buf[seq_len:]


def make_batch_iterator(
    corpus: SyntheticCorpus,
    *,
    seq_len: int,
    global_batch: int,
    host_id: int = 0,
    n_hosts: int = 1,
    extra_specs: dict[str, tuple[tuple[int, ...], Any]] | None = None,
    prefetch: int = 2,
) -> Iterator[dict[str, np.ndarray]]:
    """Host-sharded batches: this host yields rows [host_id::n_hosts].

    ``extra_specs`` adds deterministic dense inputs for multimodal stubs,
    e.g. {"frames": ((enc_seq, frontend_dim), np.float32)} or
    {"patches": ((num_patches, frontend_dim), np.float32)} per sample.
    """
    assert global_batch % n_hosts == 0
    local = global_batch // n_hosts

    def produce() -> Iterator[dict[str, np.ndarray]]:
        streams = [
            corpus.packed_sequences(seq_len, start_doc=10_000 * (host_id * local + i))
            for i in range(local)
        ]
        step = 0
        while True:
            tokens = np.stack([next(s) for s in streams])
            batch = {"tokens": tokens}
            if extra_specs:
                rng = np.random.default_rng(
                    np.random.SeedSequence([corpus.seed, 77, host_id, step]))
                for name, (shape, dtype) in extra_specs.items():
                    batch[name] = rng.standard_normal(
                        (local, *shape)).astype(dtype)
            yield batch
            step += 1

    if prefetch <= 0:
        yield from produce()
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        try:
            for item in produce():
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
