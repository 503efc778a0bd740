"""Input pipeline of the training slice: synthetic token batches, each
rank's share of them, and their transfer to the device.

:class:`SyntheticTokens` draws exactly the reference's batches (the same
numpy generator and seed), so the two packages train on identical data.
:func:`prefetch` keeps batches in flight as pinned host tensors copied to
the device with ``non_blocking`` transfers, so H2D overlaps the step.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from collections.abc import Iterator

import numpy as np
import torch

from .dataset_base import IndexedDataset


@dataclasses.dataclass
class SyntheticTokens(IndexedDataset):
    """Deterministic random token sequences for causal-LM workloads.

    Yields ``{'tokens': [B, seq_len+1] int32}``: one extra token so the LM
    task's causal shift (inputs ``[:-1]``, targets ``[1:]``) trains on
    exactly ``seq_len`` positions. ``n_distinct`` > 0 cycles through that
    many fixed batches; 0 streams fresh batches."""

    batch_size: int
    seq_len: int = 128
    vocab_size: int = 1024
    seed: int = 0
    n_distinct: int = 8

    def batch(self, index: int) -> dict[str, np.ndarray]:
        if self.n_distinct:
            index = index % self.n_distinct
        rng = np.random.default_rng((self.seed << 20) + index)
        return {
            "tokens": rng.integers(
                0,
                self.vocab_size,
                (self.batch_size, self.seq_len + 1),
                dtype=np.int32,
            )
        }


# The kinds this slice ports; the reference's other kinds (images, MLM,
# token files) are refused by name until their slice.
DATASET_KINDS: dict[str, type] = {"synthetic_tokens": SyntheticTokens}


def make_dataset(kind: str, **kwargs):
    if kind not in DATASET_KINDS:
        raise NotImplementedError(
            f"dataset kind {kind!r} not yet ported to "
            "distributeddeeplearning_tpu_torch (ported: "
            f"{sorted(DATASET_KINDS)}; the image kinds come with ResNet, "
            "ROADMAP queue A8, the MLM and token-file kinds with queues A9 "
            "and A14)"
        )
    return DATASET_KINDS[kind](**kwargs)


def sharded_batches(it, mesh) -> Iterator[dict]:
    """This rank's rows of each global host batch: every rank draws the same
    global batch from the seed and keeps its contiguous slice of the batch
    dim over the batch axes (dp, fsdp), as the reference's multi-process
    ``sharded_batches`` does. The sequence split over cp is the task's,
    after the LM shift (``train.lm_task``)."""
    from .mesh import BATCH_AXES

    n, idx = 1, 0
    for a in BATCH_AXES if mesh is not None else ():
        # row-major over the batch axes, dp outermost
        n, idx = n * mesh.shape[a], idx * mesh.shape[a] + mesh.coords[a]
    for batch in it:
        if n == 1:
            yield batch
            continue
        out = {}
        for k, x in batch.items():
            if x.shape[0] % n:
                raise ValueError(f"batch dim {x.shape[0]} of {k!r} not "
                                 f"divisible by {n} data-parallel ranks")
            per = x.shape[0] // n
            out[k] = x[idx * per:(idx + 1) * per]
        yield out


def stacked_batches(it, steps_per_call: int) -> Iterator[dict]:
    """Group ``steps_per_call`` consecutive batches into one stacked
    superbatch (leaves ``[K, B, ...]``) for multi-step dispatch
    (``Trainer.fused_train_step``), on the host, so it crosses to the
    device as one transfer. A partial tail group is dropped: fused runs
    fence their step counts to multiples of K
    (``train.check_fusion_cadences``). Stacking this rank's batches of
    :func:`sharded_batches` gives this rank's superbatches."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call={steps_per_call} must be >= 1")
    it = iter(it)
    while True:
        group = list(itertools.islice(it, steps_per_call))
        if len(group) < steps_per_call:
            return
        yield {k: np.stack([b[k] for b in group]) for k in group[0]}


def to_device(batch: dict, device) -> dict:
    """One host batch -> device tensors: pinned host memory, then a
    ``non_blocking`` copy (asynchronous on a GPU, so it overlaps the step
    in flight)."""
    device = torch.device(device)
    out = {}
    for k, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def prefetch(it, device, size: int = 2) -> Iterator[dict]:
    """Keep ``size`` batches in flight on ``device`` ahead of consumption:
    each is enqueued (pinned, ``non_blocking``) before the step that
    precedes its use."""
    queue = collections.deque()
    it = iter(it)
    for _ in range(size):
        try:
            queue.append(to_device(next(it), device))
        except StopIteration:
            break
    while queue:
        out = queue.popleft()
        try:
            queue.append(to_device(next(it), device))
        except StopIteration:
            pass
        yield out
