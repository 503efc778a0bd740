"""Input pipeline of the training slices: synthetic token and image
batches, the native loader's kinds, each rank's share of a batch, and their
transfer to the device.

:class:`SyntheticTokens` and :class:`SyntheticImages` draw exactly the
reference's batches (the same numpy generator and seed), and
:func:`augment_images` is the reference's crop-and-flip bit for bit, so the
two packages train on identical data. ``native_image`` and
``record_file_image`` come from the C++ loader (``native/loader.py``).
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
from .native.loader import (
    NativeSyntheticImages,
    RecordFileImages,
    splitmix64,
)

_U64 = (1 << 64) - 1


def _splitmix64_vec(x: np.ndarray) -> np.ndarray:
    """:func:`native.loader.splitmix64` over a uint64 array (arrays wrap
    silently where Python ints would grow)."""
    with np.errstate(over="ignore"):
        x = (x + 0x9E3779B97F4A7C15).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def augment_bits(seed: int, base_index: int, n: int,
                 pad: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dy, dx, flip) per sample: a pure function of ``seed`` and the GLOBAL
    sample index ``base_index + i``, splitmix64-mixed (the C++ loader's
    augmentation draws the same bits)."""
    idx = np.arange(n, dtype=np.uint64) + np.uint64(base_index & _U64)
    h = _splitmix64_vec(idx ^ np.uint64(splitmix64(seed & _U64)))
    span = np.uint64(2 * pad + 1)
    dy = (h % span).astype(np.int64)
    dx = ((h >> np.uint64(16)) % span).astype(np.int64)
    flip = ((h >> np.uint64(32)) & np.uint64(1)).astype(bool)
    return dy, dx, flip


def augment_images(images: np.ndarray, *, seed: int, base_index: int,
                   pad: int = 4, flip: bool = True) -> np.ndarray:
    """Random crop (zero-pad ``pad``, crop back) and horizontal flip of
    ``[B, H, W, C]`` images, each sample's draw a pure function of ``(seed,
    base_index + i)`` (:func:`augment_bits`), so resume and every rank's
    share of a batch see the same crops."""
    b, h, w, _ = images.shape
    padded = np.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="constant")
    dy, dx, do_flip = augment_bits(seed, base_index, b, pad)
    rows = dy[:, None] + np.arange(h)[None, :]
    cols = dx[:, None] + np.arange(w)[None, :]
    out = padded[np.arange(b)[:, None, None], rows[:, :, None],
                 cols[:, None, :]]
    if flip:
        out[do_flip] = out[do_flip][:, :, ::-1]
    return out


@dataclasses.dataclass
class SyntheticImages(IndexedDataset):
    """Deterministic random images and labels: ``{'image': [B, S, S, C]
    float32 normals, 'label': [B] int32}``. ``n_distinct`` > 0 cycles
    through that many fixed batches (a memorisable toy set: the loss must
    fall); 0 streams fresh batches (throughput)."""

    batch_size: int
    image_size: int = 32
    channels: int = 3
    num_classes: int = 10
    seed: int = 0
    n_distinct: int = 8

    def batch(self, index: int) -> dict[str, np.ndarray]:
        if self.n_distinct:
            index = index % self.n_distinct
        rng = np.random.default_rng((self.seed << 20) + index)
        return {
            "image": rng.standard_normal(
                (self.batch_size, self.image_size, self.image_size,
                 self.channels), dtype=np.float32),
            "label": rng.integers(0, self.num_classes, (self.batch_size,),
                                  dtype=np.int32),
        }


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


# The kinds ported so far; the reference's MLM and token-file kinds are
# refused by name until their slice.
DATASET_KINDS: dict[str, type] = {
    "synthetic_image": SyntheticImages,
    "synthetic_tokens": SyntheticTokens,
    "native_image": NativeSyntheticImages,
    "record_file_image": RecordFileImages,
}


def make_dataset(kind: str, **kwargs):
    if kind not in DATASET_KINDS:
        raise NotImplementedError(
            f"dataset kind {kind!r} not yet ported to "
            "distributeddeeplearning_tpu_torch (ported: "
            f"{sorted(DATASET_KINDS)}; the MLM and token-file kinds come "
            "with ROADMAP queues A9 and A14)"
        )
    return DATASET_KINDS[kind](**kwargs)


def sharded_batches(it, mesh, grad_accum: int = 1) -> Iterator[dict]:
    """This rank's rows of each global host batch: every rank draws the same
    global batch from the seed and keeps its share of the batch dim over
    the batch axes (dp, fsdp), as the reference's multi-process
    ``sharded_batches`` does. The sequence split over cp is the task's,
    after the LM shift (``train.lm_task``).

    The reference splits the GLOBAL batch into ``grad_accum`` contiguous
    microbatches and shards each over the ranks. So a rank's rows are its
    contiguous slice of each global microbatch in turn, and the trainer's
    contiguous split of them gives it its share of the reference's
    microbatch ``i`` (which matters where a microbatch's statistics do:
    BatchNorm). With ``grad_accum=1`` that is one contiguous slice."""
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
            if x.shape[0] % (n * grad_accum):
                raise ValueError(
                    f"batch dim {x.shape[0]} of {k!r} not divisible by "
                    f"{n} data-parallel ranks x grad_accum={grad_accum}")
            micro = x.shape[0] // grad_accum
            per = micro // n
            parts = [x[i * micro + idx * per:i * micro + (idx + 1) * per]
                     for i in range(grad_accum)]
            out[k] = parts[0] if grad_accum == 1 else np.concatenate(parts)
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
