"""Tokenized-text batches from a file on disk: the JAX package's
``data_text.py`` (the real-corpus path of the LM and MLM workloads), a copy
in numpy, since the port imports nothing of the JAX package.

On-disk format (``DDLTOK01``): a 32-byte header (magic, version, token
byte width, vocab size, token count), then a flat little-endian uint16 or
uint32 token stream. ``prepare_data.py`` writes it from raw text.

Both kinds are index-addressable: ``batch(i)`` is a pure function of
``(seed, i)``, so the checkpoint's ``next_index`` makes a resume
step-exact, as for the synthetic kinds:

- ``token_file_lm``: causal-LM rows read from the memory-mapped file (each
  process touches only the pages its rows need);
- ``token_file_mlm``: the same rows with host-side BERT-style masking,
  deterministic in ``(seed, index)`` as ``SyntheticMLM``'s.

The reference's third kind, ``grain_token_file_lm``, needs the ``grain``
package; ``data.make_dataset`` refuses it by name.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .dataset_base import IndexedDataset

_MAGIC = b"DDLTOK01"
_HEADER = struct.Struct("<8sIIQQ")  # magic, version, dtype bytes, vocab, count
_VERSION = 1


def write_token_file(path: str, tokens, vocab_size: int) -> None:
    """Write a DDLTOK01 token file; the token width follows
    ``vocab_size`` (uint16 up to 65536 words, else uint32)."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {tokens.shape}")
    # Both bounds: a negative id would wrap to an in-range one under the
    # unsigned cast below.
    if vocab_size <= 0 or (
        len(tokens)
        and (int(tokens.max()) >= vocab_size or int(tokens.min()) < 0)
    ):
        raise ValueError("tokens out of range for vocab_size")
    dtype = np.uint16 if vocab_size <= 1 << 16 else np.uint32
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, dtype().itemsize, vocab_size,
                             len(tokens)))
        f.write(np.ascontiguousarray(tokens, dtype=dtype).tobytes())


def read_token_file(path: str) -> tuple[np.memmap, int]:
    """Memory-map a DDLTOK01 file -> (tokens, vocab_size)."""
    with open(path, "rb") as f:
        header = f.read(_HEADER.size)
    if len(header) < _HEADER.size:
        raise ValueError(f"{path}: truncated token-file header")
    magic, version, itemsize, vocab, count = _HEADER.unpack(header)
    if magic != _MAGIC or version != _VERSION:
        raise ValueError(f"{path}: not a DDLTOK01 token file")
    dtype = {2: np.uint16, 4: np.uint32}.get(itemsize)
    if dtype is None:
        raise ValueError(f"{path}: unsupported token width {itemsize}")
    tokens = np.memmap(path, dtype=dtype, mode="r", offset=_HEADER.size,
                       shape=(count,))
    return tokens, vocab


class _TokenFileBase(IndexedDataset):
    """The stream cut into ``n_seq`` non-overlapping rows of ``seq_len``
    tokens (plus one lookahead token for the causal shift); each epoch
    visits every row once in the permutation seeded by ``(seed << 20) ^
    epoch``, and an epoch's trailing partial batch is dropped."""

    def _setup(self, path: str, seq_len: int, batch_size: int):
        if not path:
            raise ValueError(f"{type(self).__name__} requires data.path")
        self._tokens, self.vocab_size = read_token_file(path)
        self._n_seq = (len(self._tokens) - 1) // seq_len
        if self._n_seq < batch_size:
            raise ValueError(
                f"{path}: only {self._n_seq} sequences of length {seq_len}; "
                f"need >= batch_size ({batch_size})"
            )
        self._batches_per_epoch = self._n_seq // batch_size
        self._perm_cache: dict[int, np.ndarray] = {}

    def _perm(self, epoch: int) -> np.ndarray:
        if epoch not in self._perm_cache:
            if len(self._perm_cache) > 2:
                self._perm_cache.clear()
            self._perm_cache[epoch] = np.random.default_rng(
                (self.seed << 20) ^ epoch).permutation(self._n_seq)
        return self._perm_cache[epoch]

    def _sequences(self, index: int, extra: int) -> np.ndarray:
        """[batch, seq_len + extra] int32 rows of batch ``index``."""
        epoch, k = divmod(index, self._batches_per_epoch)
        rows = self._perm(epoch)[k * self.batch_size:
                                 (k + 1) * self.batch_size]
        out = np.empty((self.batch_size, self.seq_len + extra), np.int32)
        for b, j in enumerate(rows):
            start = int(j) * self.seq_len
            out[b] = self._tokens[start:start + self.seq_len + extra]
        return out


@dataclasses.dataclass
class TokenFileLM(_TokenFileBase):
    """Causal-LM batches from a DDLTOK01 file: ``{'tokens': [B, L+1]}``
    (one lookahead token, ``SyntheticTokens``' contract)."""

    path: str
    batch_size: int
    seq_len: int = 128
    seed: int = 0

    def __post_init__(self):
        self._setup(self.path, self.seq_len, self.batch_size)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        return {"tokens": self._sequences(index, extra=1)}


@dataclasses.dataclass
class TokenFileMLM(_TokenFileBase):
    """BERT-style MLM batches from a DDLTOK01 file, masked on the host with
    a pattern deterministic in ``(seed, index)``."""

    path: str
    batch_size: int
    seq_len: int = 128
    mask_prob: float = 0.15
    mask_token_id: int = 3
    seed: int = 0

    def __post_init__(self):
        self._setup(self.path, self.seq_len, self.batch_size)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        tokens = self._sequences(index, extra=0)
        rng = np.random.default_rng((self.seed << 20) + 0x3A5C + index)
        masked = rng.random(tokens.shape) < self.mask_prob
        inputs = np.where(masked, np.int32(self.mask_token_id), tokens)
        labels = np.where(masked, tokens, np.int32(-1))
        return {"input_tokens": inputs, "labels": labels}
