"""The check comes out false for the control and for every fault a cell can
have, and true for the program as it is."""

import pytest

from dpu_olap_tpu_torch.ops import aggregate, join
from dpu_olap_tpu_torch.parallel import dist_join
from dpu_olap_tpu_torch.parallel.process_group import GroupSet
from olapbench.tests import faults
from olapbench.tests.cells import line_of

ONE, FOUR = "bm_join_sf128-join_sum", "bm_join_sf256_x4-shuffle_join_sum"


@pytest.fixture
def restore_program(monkeypatch):
    """Undo, after the test, what a fault patches in this process (a
    one-chip run calls it here; spawned ranks die with theirs)."""
    for owner, name in ((join, "join_shard_auto"), (dist_join, "dist_join"),
                        (aggregate, "sum_u64_pair"), (GroupSet, "exchange")):
        monkeypatch.setattr(owner, name, getattr(owner, name))


def checks(line):
    return {k: c["value"] for k, c in line["checks"].items()}


@pytest.mark.parametrize("cell", [ONE, FOUR])
def test_control_is_not_correct(cell):
    line = line_of(cell, control=True)
    got = checks(line)
    assert line["correct"] is False
    assert got["answers_wrong"] >= 1 and got["rows_wrong"] == 0  # only the 32-bit sum differs


@pytest.mark.parametrize("cell, fault, caught_by", [
    (ONE, faults.half_the_probe_rows, ("rows_wrong", "answers_wrong")),
    (ONE, faults.sum_off_by_one, ("answers_wrong",)),
    (FOUR, faults.half_the_probe_rows, ("rows_wrong", "answers_wrong")),
    (FOUR, faults.sum_off_by_one, ("answers_wrong",)),
    (FOUR, faults.no_exchange, ("rows_wrong", "answers_wrong")),
])
def test_a_broken_program_is_not_correct(cell, fault, caught_by, restore_program):
    line = line_of(cell, hook=fault)
    got = checks(line)
    assert line["correct"] is False
    assert all(got[name] >= 1 for name in caught_by), got


@pytest.mark.parametrize("control", [False, True])
def test_limit_readings_over_several_seeds(control):
    from olapbench.tests.cells import readings

    seeds = [1, 2**31 + 7, 2**33 + 5]
    got = readings(FOUR, seeds, control=control)
    assert list(got) == seeds
    for correct, numbers in got.values():
        assert correct is not control and numbers["failed_queries"] == 0
        assert (numbers["answers_wrong"] >= 2) is control  # every query, warm-up not counted
