"""Host-side batching helpers (numpy only).

Port of `eval_batches` from the JAX package's data/pipeline.py. The rest of
the host data path (frame table, samplers, prefetcher) comes with ROADMAP
Queue A item 7.
"""
from __future__ import annotations

import numpy as np


def eval_batches(n: int, bs: int) -> tuple[np.ndarray, int]:
    """Index batches covering ALL n records at batch size bs.

    The tail batch is padded by repeating the last record; returns
    (batches, n_pad) so the caller can mask the padded rows out of the
    confusion matrix (labels set to 255 count nowhere)."""
    n_full = (n // bs) * bs
    batches = np.arange(n_full).reshape(-1, bs)
    n_pad = 0
    if n_full < n:
        n_pad = bs - (n - n_full)
        tail = np.concatenate([np.arange(n_full, n),
                               np.full((n_pad,), n - 1, dtype=np.int64)])
        batches = np.concatenate([batches, tail[None]], axis=0)
    return batches, n_pad
