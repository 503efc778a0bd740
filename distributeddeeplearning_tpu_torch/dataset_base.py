"""Dataset base contract, a copy of the JAX package's ``dataset_base`` (that
module imports no JAX, but the port imports nothing of the JAX package)."""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np


class IndexedDataset:
    """Base for datasets addressable by batch index: ``batch(i)`` is pure and
    deterministic, which is what makes resume step-exact and parity tests
    independent of placement."""

    def batch(self, index: int) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def iter_from(self, start: int = 0) -> Iterator[dict[str, np.ndarray]]:
        i = start
        while True:
            yield self.batch(i)
            i += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.iter_from(0)
