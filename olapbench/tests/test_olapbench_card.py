"""On the card: the one-chip cell through the harness at a reduced size, its
device metrics read from a real trace. Skips without a CUDA device."""

import pytest
import torch

from olapbench.tests.cells import line_of


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only there")
    return "cuda:0"


@pytest.mark.cuda
def test_one_chip_cell_on_the_card(card):
    line = line_of("bm_join_sf128-join_sum", device=card, rows=1 << 21, seconds=1.0)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0 and line["metrics"]["device_gib_peak"]


@pytest.mark.cuda
def test_one_chip_trace_on_the_card(card):
    line = line_of("bm_join_sf128-join_sum", device=card, rows=1 << 21, seconds=1.0, trace=True)
    m = line["metrics"]
    assert line["correct"] is True and 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < m["query_roofline"]["value"] <= 100 and m["dtoh_syncs_per_query"]["value"] >= 1
    assert 0 <= m["glue_device_share"]["value"] <= 100
    assert line["breakdown"]["device_ops"]


@pytest.mark.cuda
def test_control_on_the_card(card):
    line = line_of("bm_join_sf128-join_sum", device=card, rows=1 << 21, seconds=1.0,
                   control=True)
    assert line["correct"] is False and line["checks"]["answers_wrong"]["value"] >= 1
