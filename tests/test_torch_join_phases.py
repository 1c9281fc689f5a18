"""bench/kernel_replay.py's join_phases group (the counterpart of
scripts/profile_join_phases.py) on the CPU at 1/256 of its rows: the three
chained prefixes of the fused co-sort join and their differences, each
prefix's step against numpy's own co-sort, fill and join of the same rows,
and the group's place in the command line."""

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.bench import kernel_replay as kr
from dpu_olap_tpu_torch.ops.merge import EMPTY

SHRINK = 256


@pytest.fixture(scope="module")
def inputs():
    return kr.join_phase_inputs("cpu", SHRINK)


def test_readings(inputs):
    # small tensors: one thread, so that the chains do not contend for cores
    # with the other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ms = kr.join_phase_readings("cpu", SHRINK, reps=3)
    finally:
        torch.set_num_threads(threads)
    assert list(ms) == ["join_sort", "join_sort_fill", "join_full", "fill_delta", "mask_delta"]
    assert all(ms[k] > 0 for k in kr.JOIN_PREFIXES)


def _numpy_phases(fk, y, pk, x):
    """The keys31 co-sort, its forward fill and the join, in numpy."""
    k2 = np.concatenate([pk.astype(np.int64) << 1, (fk.astype(np.int64) << 1) | 1])
    pay = np.concatenate([x, y])
    order = np.argsort(k2, kind="stable")
    sk2, sp = k2[order], pay[order]
    is_pk = (sk2 & 1) == 0
    last = np.maximum.accumulate(np.where(is_pk, np.arange(len(sk2)), -1))
    fkey = np.where(last >= 0, sk2[np.maximum(last, 0)] >> 1, EMPTY)
    fpay = np.where(last >= 0, sp[np.maximum(last, 0)], 0)
    matched = ~is_pk & (fkey == sk2 >> 1)
    return sk2.astype(np.uint32), fkey.astype(np.uint32), fpay, np.where(matched, sk2 >> 1, 0)


def test_prefix_steps_match_numpy(inputs):
    fk, y, pk, x = inputs
    sk2, fkey, fpay, joined = _numpy_phases(*(t.numpy() for t in inputs))
    n = fk.shape[0]
    keys = fk.numpy()
    for name, plane in (("join_sort", sk2), ("join_sort_fill", fkey), ("join_full", joined)):
        got = kr.JOIN_PREFIXES[name](fk, y, pk, x).numpy()
        np.testing.assert_array_equal(got, keys ^ (plane[:n].astype(np.uint32) & 1))
        assert got.max() < pk.shape[0]  # the folded keys stay keys of the build side
    filled = kr._filled(fk, y, pk, x)
    np.testing.assert_array_equal(filled[1].numpy()[fkey != EMPTY], fpay[fkey != EMPTY])


def test_group_is_listed_and_needs_a_card(monkeypatch):
    assert kr.GROUPS[-1] == "join_phases"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kr.main(["--only", "join_phases"]) == 1
