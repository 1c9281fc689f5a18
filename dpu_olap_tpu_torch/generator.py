"""Seeded data generation (counterpart of ``dpu_olap_tpu/generator.py``).

The same numpy ``default_rng(seed)`` draws in the same order as the JAX
package, so both packages see bit-identical seed-42 arrays. Reference:
host/generator/generator.cc — random uint32 columns (:22-30), a globally
sequential pk (:59-71), and fk uniform inside its batch's pk range (:46-57).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .columnar import Batch, Table

DEFAULT_SEED = 42


class Generator:
    """Deterministic batch generator (arrow::random::RandomArrayGenerator analog)."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.rng = np.random.default_rng(seed)

    def random_column(
        self, n: int, dtype=np.uint32, lo: int | None = None, hi: int | None = None
    ) -> np.ndarray:
        """Uniform column over [lo, hi] (inclusive), defaulting to the full
        dtype range."""
        info = np.iinfo(dtype)
        lo = info.min if lo is None else lo
        hi = info.max if hi is None else hi
        return self.rng.integers(lo, hi, size=n, dtype=dtype, endpoint=True)

    def random_batches(
        self,
        names: Sequence[str],
        num_batches: int,
        batch_size: int,
        dtype=np.uint32,
    ) -> List[dict]:
        return [
            {name: self.random_column(batch_size, dtype) for name in names}
            for _ in range(num_batches)
        ]

    @staticmethod
    def index_column(batch_index: int, batch_size: int) -> np.ndarray:
        """Sequential pk column; continues across batches (generator.cc:59-71)."""
        start = batch_index * batch_size
        return np.arange(start, start + batch_size, dtype=np.uint32)

    def foreign_key_column(
        self, batch_index: int, pk_batch_size: int, batch_size: int
    ) -> np.ndarray:
        """fk uniform within the matching pk batch range (generator.cc:46-57)."""
        lo = batch_index * pk_batch_size
        hi = (batch_index + 1) * pk_batch_size - 1
        return self.random_column(batch_size, np.uint32, lo, hi)


def make_join_tables(
    num_batches: int,
    left_batch_size: int,
    right_batch_size: int,
    seed: int = DEFAULT_SEED,
    device=None,
) -> tuple[Table, Table]:
    """The BM_JoinDpu workload (host/join/join_benchmark.cc:67-107):
    right = (pk sequential, x random uint32), left = (fk uniform within the
    matching right batch's pk range, y random uint32)."""
    g = Generator(seed)
    right_rand = g.random_batches(["x"], num_batches, right_batch_size)
    right = Table(
        [
            Batch.from_numpy(
                {"pk": Generator.index_column(i, right_batch_size), **right_rand[i]},
                device=device,
            )
            for i in range(num_batches)
        ]
    )
    left_rand = g.random_batches(["y"], num_batches, left_batch_size)
    left = Table(
        [
            Batch.from_numpy(
                {
                    "fk": g.foreign_key_column(i, right_batch_size, left_batch_size),
                    **left_rand[i],
                },
                device=device,
            )
            for i in range(num_batches)
        ]
    )
    return left, right


def make_filter_batches(
    num_batches: int, batch_size: int, seed: int = DEFAULT_SEED, device=None
) -> Table:
    """The BM_Filter workload (host/filter/filter_benchmark.cc:77-103):
    single random uint32 column 'a'."""
    g = Generator(seed)
    return Table(
        [
            Batch.from_numpy(b, device=device)
            for b in g.random_batches(["a"], num_batches, batch_size)
        ]
    )


def make_take_batches(
    num_batches: int,
    batch_size: int,
    indices_size: int,
    seed: int = DEFAULT_SEED,
    device=None,
) -> tuple[Table, Table]:
    """The BM_Take workload (host/take/take_benchmark.cc:59-104): a data column
    plus uniform indices in [0, batch_size)."""
    g = Generator(seed)
    data = Table(
        [
            Batch.from_numpy(b, device=device)
            for b in g.random_batches(["a"], num_batches, batch_size)
        ]
    )
    idx = Table(
        [
            Batch.from_numpy(
                {"i": g.random_column(indices_size, np.uint32, 0, batch_size - 1)},
                device=device,
            )
            for _ in range(num_batches)
        ]
    )
    return data, idx
