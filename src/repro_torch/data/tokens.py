"""Deterministic synthetic LM token pipeline (a copy of the reference's
``repro.data.tokens``, which the port may not import).

Every batch is a pure function of (seed, step, host shard): numpy's
counter-based Philox generator keyed by the seed, its counter set to
(step, host_id), so a resumed run sees exactly the batches an uninterrupted
one would, and the batches are bit for bit the reference's.  The
distribution is a Zipfian unigram with a per-sequence "topic" shift, enough
structure for a loss to fall without a corpus.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream", "make_batch_iterator"]


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide n_hosts")
        self.local_batch = self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        """The host-local batch of ``step``, ``{"tokens": (B, S) int32}``."""
        rng = np.random.default_rng(
            np.random.Philox(key=self.seed, counter=[step, self.host_id, 0, 0]))
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        base = rng.zipf(self.zipf_a, size=(b, s)).astype(np.int64)
        topic = rng.integers(0, max(v // 8, 1), size=(b, 1))
        return {"tokens": ((base + topic) % v).astype(np.int32)}

    def state(self) -> dict:
        return {"seed": self.seed, "n_hosts": self.n_hosts, "host_id": self.host_id}


def make_batch_iterator(stream: TokenStream, start_step: int = 0):
    step = start_step
    while True:
        yield step, stream.batch_at(step)
        step += 1
