"""The plain reference: the PK/FK inner join and SUM(x) over it, in plain
PyTorch, from the columns the benchmark made.

It imports nothing of the program under test. Each probe row (fk, y) finds
the build row whose pk equals fk by a sort of the build keys and a binary
search, so it assumes nothing of the keys' order or density; pk is a
primary key, so a probe row matches at most once. Rows are int64 (fk, y, x)
triples; the sum is exact in int64 (fewer than 2^31 values below 2^32).

``canonical`` orders rows by (fk, y): x is a function of fk, so equal keys
are equal rows and two correct outputs are equal element for element.
``judge`` gives the numbers a join query's check compares, each with its
limit: 0, as the configurations state an exact join and an exact sum.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def widen(col: torch.Tensor) -> torch.Tensor:
    """A uint32 column (or its int32 view) as int64 values."""
    return col.view(torch.int32).to(torch.int64) & MASK32


def join(fk: torch.Tensor, y: torch.Tensor, pk: torch.Tensor, x: torch.Tensor):
    """The matched rows (fk, y, x) of probe (fk, y) against build (pk, x),
    int64, in probe order."""
    pk64 = widen(pk)
    spk, order = torch.sort(pk64)
    del pk64
    fk64 = widen(fk)
    pos = torch.searchsorted(spk, fk64).clamp_(max=spk.shape[0] - 1)
    hit = spk[pos] == fk64
    del spk
    xs = widen(x.view(torch.int32)[order[pos[hit]]])
    return fk64[hit], widen(y)[hit], xs


def canonical(fk: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """Rows ordered by (fk, y): the packed key fk << 32 | y (fk < 2^31) and
    x in the same order."""
    key = (fk << 32) | y
    key, order = torch.sort(key)
    return key, x[order]


def exact_sum(x: torch.Tensor) -> int:
    """SUM(x) over the matched rows, exact (x int64 values below 2^32)."""
    return int(x.sum())


def sum_32(x: torch.Tensor) -> int:
    """The control's SUM(x): accumulated in 32 bits, the width below the
    configuration's uint64 sum, so it wraps modulo 2^32."""
    return int(x.sum()) & MASK32


def rows_wrong(got, want) -> int:
    """How far two sets of rows (fk, y, x) differ: the gap in their counts
    plus the rows that differ, in canonical order, over the shorter."""
    gk, gx = canonical(*got)
    wk, wx = canonical(*want)
    n = min(gk.shape[0], wk.shape[0])
    differ = ((gk[:n] != wk[:n]) | (gx[:n] != wx[:n])).sum()
    return abs(gk.shape[0] - wk.shape[0]) + int(differ)


def judge(got_rows, answers, want_rows, want_sum) -> dict:
    """{name: (value, limit)}: the window's answers unlike the reference's
    SUM(x), and how far the program's rows lie from the reference's."""
    return {"answers_wrong": (sum(1 for a in answers if a != want_sum), 0),
            "rows_wrong": (rows_wrong(got_rows, want_rows), 0)}
