"""The port's chained timing (dpu_olap_tpu_torch.bench.device_time) on CPU
tensors: the readings, the consts passed to every step, and the round-robin
order of time_chained_multi; bench/kernel_replay without a card.
The graph-captured path on the card is in tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

from dpu_olap_tpu_torch.bench import device_time


def _x(n=4096):
    return torch.from_numpy(np.arange(n, dtype=np.uint32))


def test_time_chained_positive_and_consts_are_arguments():
    table = torch.from_numpy(np.arange(7, dtype=np.uint32))
    seen = []

    def step(c, t):
        seen.append(t)
        return c ^ t[:1]

    sec = device_time.time_chained(step, _x(), k=3, reps=3, consts=(table,))
    assert sec > 0
    # warm k and 2k chains, then 3 reps of (k + 2k) steps
    assert len(seen) == 3 + 6 + 3 * 9 and all(t is table for t in seen)


def test_time_chained_chains_each_step_on_the_last():
    carries = []

    def step(c):
        carries.append(int(c[0]))
        return c + 1

    device_time.time_chained(step, torch.zeros(4, dtype=torch.int64), k=2, reps=1)
    assert carries == [0, 1] + [0, 1, 2, 3] + [0, 1] + [0, 1, 2, 3]


def test_time_chained_multi_visits_candidates_round_robin():
    calls = []

    def make(name, out):
        def step(c, *consts):
            calls.append((name, consts))
            return c ^ out
        return step

    x = _x()
    one = torch.ones(1, dtype=torch.uint32)
    specs = [("a", make("a", 1), x, 2), ("b", make("b", 2), x, 1, (one,)), ("c", make("c", 3), x, 3)]
    spread = {}
    res = device_time.time_chained_multi(specs, reps=3, spread=spread)
    assert list(res) == ["a", "b", "c"] and all(v > 0 for v in res.values())
    assert all(len(spread[n]) == 3 and spread[n] == sorted(spread[n]) for n in res)
    ks = {"a": 2, "b": 1, "c": 3}
    warm = [n for n in "abc" for _ in range(3 * ks[n])]  # each candidate's k and 2k chains
    rep = [n for n in "abc" for _ in range(3 * ks[n])]
    assert [n for n, _ in calls] == warm + rep * 3
    assert all(consts == ((one,) if n == "b" else ()) for n, consts in calls)


def test_time_chained_median_of_reps():
    assert device_time._median([3.0, 1.0, 2.0]) == 2.0
    assert device_time._median([-1.0]) == 1e-9  # a negative difference reads as the floor


def test_time_chained_rejects_other_devices():
    x = torch.zeros(4, dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        device_time.time_chained(lambda c: c, x, k=1, reps=1)


def test_sort_gather_replay_needs_a_card(capsys, monkeypatch):
    from dpu_olap_tpu_torch.bench import kernel_replay

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_replay.main([]) == 1
    assert capsys.readouterr().out == ""  # no reading without a card
