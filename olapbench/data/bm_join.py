"""BM_JoinDpu's tables, made on the device from the run's seed.

The rules are those of the upstream suite's generator (host/generator/
generator.cc; host/join/join_benchmark.cc:67-107): each side comes in
batches of ``batch_rows`` rows; the build side is (pk, x) with pk
sequential over the whole table and x a random uint32; the probe side is
(fk, y) with fk uniform within its batch's pk range and y a random uint32.

A chip holds a block of ``batches_per_chip`` consecutive batches of each
side. A side's block is drawn in a few large calls of one
``torch.Generator`` seeded from (seed, side, block), so any block can be
made again, on any process, bit for bit: the reference makes every build
block to check one rank's rows. Columns are uint32 tensors.

A configuration names its data module by ``generator``; each module gives
``probe_block``, ``build_block``, ``rows`` and ``probe_owner``.
"""

from __future__ import annotations

import hashlib

import torch


def block_seed(seed: int, side: str, block: int) -> int:
    """A 63-bit generator seed for one side's block of one run's seed."""
    digest = hashlib.sha256(f"olapbench/{seed}/{side}/{block}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _random_u32(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen, dtype=torch.int32,
                         device=device).view(torch.uint32)


def rows(cfg: dict) -> tuple:
    """(probe rows, build rows) a chip holds."""
    n = cfg["batches_per_chip"] * cfg["batch_rows"]
    return n, n


def probe_owner(fk: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The block, and so the rank, that made each probe row: its fk lies in
    its batch's pk range (fk given as int64)."""
    return fk // rows(cfg)[0]


def _block(seed: int, side: str, block: int, cfg: dict, device):
    """(generator, first row, rows, batch rows) of one side's block."""
    n = rows(cfg)[0]
    first = block * n
    if first + n > 0x7FFFFFFF:
        raise ValueError("keys must stay below 2^31 - 1")
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, side, block))
    return gen, first, n, cfg["batch_rows"]


def build_block(seed: int, block: int, cfg: dict, device):
    """(pk, x) of build block ``block``: pk sequential from its first row."""
    gen, first, n, _ = _block(seed, "build", block, cfg, device)
    x = _random_u32(n, gen, device)
    pk = (torch.arange(n, dtype=torch.int32, device=device) + first).view(torch.uint32)
    return pk, x


def probe_block(seed: int, block: int, cfg: dict, device):
    """(fk, y) of probe block ``block``: fk the first pk of its batch plus a
    uniform offset within the batch."""
    gen, first, n, batch = _block(seed, "probe", block, cfg, device)
    offset = torch.randint(0, batch, (n,), generator=gen, dtype=torch.int32, device=device)
    y = _random_u32(n, gen, device)
    row = torch.arange(n, dtype=torch.int32, device=device)
    fk = ((row // batch) * batch + first + offset).view(torch.uint32)
    return fk, y
