"""Arrow-layout columnar Batch/Table over host numpy or torch tensors
(counterpart of ``dpu_olap_tpu/columnar.py``).

A column is a host ``numpy.ndarray`` or a ``torch.Tensor`` on a device; a
batch is a dict of equally-long columns. uint32 columns keep their exact
bytes in both (``torch.uint32``), so the port sees what the JAX package
sees. Only fixed-width primitive types are supported, as in the reference
(host/dpuext/arrow_utils.cc:41-45).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np
import torch

try:  # pyarrow is optional at runtime; required for the Arrow bridge + oracles
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


def to_numpy(col) -> np.ndarray:
    """A column as host numpy (copies a device tensor to the host)."""
    if isinstance(col, torch.Tensor):
        return col.cpu().numpy()
    return np.asarray(col)


@dataclasses.dataclass
class Batch:
    """A record batch: named, equally-long columns."""

    columns: Dict[str, object]

    def __post_init__(self):
        lengths = {k: int(v.shape[0]) for k, v in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged batch: {lengths}")

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return int(next(iter(self.columns.values())).shape[0])

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def __getitem__(self, name: str):
        return self.columns[name]

    def select(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names})

    def add_column(self, name: str, col, index: int | None = None) -> "Batch":
        """Insert a column (reference generator::AddColumn inserts at index 0,
        host/generator/generator.cc:32-44); at the end by default."""
        items = list(self.columns.items())
        if index is None:
            index = len(items)
        items.insert(index, (name, col))
        return Batch(dict(items))

    def take(self, indices) -> "Batch":
        """Rows at ``indices`` through ops/take.take (indices read unsigned
        and clipped to the last row). A host column gives a host column, a
        tensor a tensor on its device."""
        from .ops.take import take

        idx = indices if isinstance(indices, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(indices))
        out = {}
        for n, c in self.columns.items():
            if isinstance(c, torch.Tensor):
                out[n] = take(c, idx.to(c.device))
            else:
                out[n] = take(torch.from_numpy(c), idx.cpu()).numpy()
        return Batch(out)

    def slice(self, start: int, length: int) -> "Batch":
        return Batch({n: c[start : start + length] for n, c in self.columns.items()})

    # ---- host interop ------------------------------------------------------

    @staticmethod
    def from_numpy(columns: Mapping[str, np.ndarray], device=None) -> "Batch":
        """Wrap host columns. With device=None they stay host numpy (operators
        move them to the device themselves); with a torch device they are
        copied there now."""
        if device is not None:
            device = torch.device(device)
            return Batch(
                {n: torch.from_numpy(np.ascontiguousarray(c)).to(device)
                 for n, c in columns.items()}
            )
        return Batch({n: np.ascontiguousarray(c) for n, c in columns.items()})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {n: to_numpy(c) for n, c in self.columns.items()}

    @property
    def is_device(self) -> bool:
        """True when every column is a torch tensor (not yet materialized to
        host numpy)."""
        return bool(self.columns) and all(
            isinstance(c, torch.Tensor) for c in self.columns.values()
        )

    @staticmethod
    def from_arrow(rb: "pa.RecordBatch", device=None) -> "Batch":
        """Zero-copy (host side) import of a pyarrow RecordBatch."""
        cols = {}
        for name, col in zip(rb.schema.names, rb.columns):
            if col.null_count:
                raise ValueError("null values not supported (reference: non-nullable)")
            cols[name] = col.to_numpy(zero_copy_only=True)
        return Batch.from_numpy(cols, device=device)

    def to_arrow(self) -> "pa.RecordBatch":
        np_cols = self.to_numpy()
        arrays = [pa.array(c) for c in np_cols.values()]
        return pa.RecordBatch.from_arrays(arrays, names=list(np_cols.keys()))


class Table:
    """A sequence of batches with a common schema (arrow::Table analog)."""

    def __init__(self, batches: Iterable[Batch]):
        self.batches: List[Batch] = list(batches)

    @property
    def num_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)

    @property
    def names(self) -> List[str]:
        return self.batches[0].names if self.batches else []

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def __getitem__(self, i: int) -> Batch:
        return self.batches[i]

    def concat(self) -> Batch:
        def cat(cols):
            if all(isinstance(c, torch.Tensor) for c in cols):
                return torch.cat(cols)
            return np.concatenate([to_numpy(c) for c in cols])

        return Batch({n: cat([b[n] for b in self.batches]) for n in self.names})

    @property
    def is_device(self) -> bool:
        """True when every batch is device-resident (see Batch.is_device)."""
        return bool(self.batches) and all(b.is_device for b in self.batches)

    def to_host(self) -> "Table":
        """Materialize every column to host numpy (the final gather)."""
        return Table([Batch(b.to_numpy()) for b in self.batches])

    def to_arrow(self) -> "pa.Table":
        return pa.Table.from_batches([b.to_arrow() for b in self.batches])

    @staticmethod
    def from_arrow(t: "pa.Table", device=None) -> "Table":
        return Table([Batch.from_arrow(rb, device=device) for rb in t.to_batches()])

    @staticmethod
    def from_reference(t) -> "Table":
        """The port's Table with the same bytes as a JAX-package Table ``t``:
        each column is read through ``np.asarray``, so this needs no jax
        import. The result is host-resident."""
        return Table(
            [Batch.from_numpy({n: np.asarray(c) for n, c in b.columns.items()})
             for b in t.batches]
        )
