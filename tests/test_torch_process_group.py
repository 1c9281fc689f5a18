"""The port's process-group form (dpu_olap_tpu_torch.parallel.process_group,
shuffle.exchange_group as the GroupSet's exchange, shuffle_partitions,
dist_join, dist_join_retry and the 2-D shuffle and join over a GroupSet and
a ProcessMesh2D, dist_join_phase_ms_group, and bench/multiproc.py) in one
spawn of 4 gloo ranks on the
CPU, a ``file://`` rendezvous under the test's temporary directory. Every
case runs inside that spawn, at world 4, at world 2 (a subgroup of ranks 0
and 1), at world 1 (a subgroup of each rank) and on the 2 x 2 mesh; the
ranks return numpy arrays, and this process holds them bit for bit against
the one-controller form over ``DeviceSet([cpu] * d)`` and, rows after a
canonical sort, against the JAX package's dist_join / dist_join_2d on a
d-device slice of the virtual mesh and against pyarrow.

The ranks import this module to find their function, so JAX is imported
only inside the checks that compare with it."""

import subprocess
import sys
from pathlib import Path
from queue import Queue

import numpy as np
import pyarrow as pa
import pytest
import torch

from dpu_olap_tpu_torch.bench import multiproc
from dpu_olap_tpu_torch.generator import make_join_tables
from dpu_olap_tpu_torch.metrics import counts
from dpu_olap_tpu_torch.bench.multiproc import shard
from dpu_olap_tpu_torch.parallel import dist_join as dj
from dpu_olap_tpu_torch.parallel import process_group as pg
from dpu_olap_tpu_torch.parallel import shuffle
from dpu_olap_tpu_torch.parallel.dist_join import dist_join, dist_join_retry
from dpu_olap_tpu_torch.parallel.mesh import DeviceSet
from dpu_olap_tpu_torch.parallel.multihost import (
    dist_join_2d,
    make_mesh_2d,
    shuffle_partitions_2d,
)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
SHUFFLES = [(d, rounds, inband) for d in (2, 4) for rounds in (1, 2) for inband in (False, True)]
JOINS = [(2, "cosort"), (4, "cosort"), (4, "sort")]
MP_ROWS = 1 << 10  # rank_join's batch rows here: BM_JoinDpu's 2Mi cut to 1Ki


def _tables():
    left, right = make_join_tables(8, 1 << 11, 1 << 10)
    lc, rc = left.concat(), right.concat()
    return left, right, (lc["fk"], lc["y"], rc["pk"], rc["x"])


def _shuffle_inputs(d, rounds):
    rng = np.random.default_rng(100 * d + rounds)
    n = d * 1024
    return (rng.integers(0, 2**32, n, dtype=np.uint32), np.arange(n, dtype=np.uint32),
            shuffle.default_cell_size(n // d, d * rounds, 2.0))


def _skewed(n, seed):
    # 40% of fks on one hot key: the default cells overflow
    rng = np.random.default_rng(seed)
    pk = np.arange(n, dtype=np.uint32)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    fk = np.where(rng.random(n) < 0.4, np.uint32(rng.integers(0, n)),
                  rng.integers(0, n, n).astype(np.uint32))
    return fk, np.arange(n, dtype=np.uint32), pk, x


def _host(out):
    """A join's outputs (fk, left_cols, right_cols, matched, overflow) as
    host arrays."""
    fk, lcols, rcols, matched, overflow = out
    return (fk.numpy(), tuple(c.numpy() for c in lcols), tuple(c.numpy() for c in rcols),
            matched.numpy(), overflow.numpy())


def _counted(fn):
    """fn()'s result and what the exchanges counted meanwhile."""
    names = ("exchange.copies", "exchange.bytes", "exchange.collectives")
    before = counts()
    out = fn()
    after = counts()
    return out, tuple(after.get(n, 0) - before.get(n, 0) for n in names)


def _rank_cases(gs):
    """Every case, in one rank of the spawn: each rank creates the same
    subgroups in the same order."""
    torch.set_num_threads(1)
    res = {}
    one = gs.subgroups([[r] for r in range(gs.world_size)])
    pair = gs.subgroups([[0, 1]])

    # the exchange itself, at world 4 on both axes, and at world 1
    block = torch.arange(WORLD * 3 * 2, dtype=torch.int32).reshape(WORLD * 3, 2) + 100 * gs.rank
    res["exchange0"] = _counted(lambda: shuffle.exchange_group(block, gs).numpy())
    wide = block.reshape(3, WORLD * 2)
    res["exchange1"] = shuffle.exchange_group(wide, gs, axis=1).numpy()
    res["exchange_w1"] = _counted(lambda: shuffle.exchange_group(block, one).numpy())
    res["set_exchange"] = [x.numpy() for x in gs.exchange((block,))]
    res["gather"] = gs.gather(torch.from_numpy(np.arange(gs.rank + 1, dtype=np.uint32)
                                               + np.uint32(10 * gs.rank)))
    res["any"] = (gs.any(torch.tensor([gs.rank == 3])), gs.any(torch.zeros(2, dtype=torch.bool)))

    for d, rounds, inband in SHUFFLES:
        g = gs if d == WORLD else pair
        if g is None:
            continue
        keys, pay, cell = _shuffle_inputs(d, rounds)
        (r,), counted = _counted(lambda: shuffle.shuffle_partitions(
            g.split(keys), (g.split(pay),), d, cell, rounds=rounds, counts_inband=inband,
            ds=g))
        res[("shuffle", d, rounds, inband)] = (
            r.keys.numpy(), r.payloads[0].numpy(), r.counts.numpy(), r.overflow.numpy(),
            r.rounds, counted)

    _, _, (lfk, ly, rpk, rx) = _tables()
    for d, impl in JOINS:  # the whole columns: each rank takes its rows
        g = gs if d == WORLD else pair
        if g is not None:
            res[("join", d, impl)] = _host(shard(dist_join(g, lfk, (ly,), rpk, (rx,),
                                                           impl=impl), 0))

    fk, y, pk, x = _skewed(WORLD * 1024, 3)
    out, cells = dist_join_retry(gs, fk, (y,), pk, (x,))
    res["retry"] = (_host(shard(out, 0)), cells)

    mesh = make_mesh_2d(group=gs, chips_per_host=2)
    res["mesh"] = (mesh.shape, mesh.host, mesh.chip, mesh.host_group.ranks,
                   mesh.chip_group.ranks, mesh.host_group.rank, mesh.chip_group.rank)
    for rounds in (1, 2):
        keys, pay, cell = _shuffle_inputs(WORLD, rounds)
        (r,) = shuffle_partitions_2d(gs.split(keys), (gs.split(pay),), 2, 2, cell,
                                     rounds=rounds, mesh=mesh)
        res[("shuffle2d", rounds)] = (r.keys.numpy(), r.payloads[0].numpy(), r.counts.numpy())
        # this rank's shards: the tuples are taken as they are
        res[("join2d", rounds)] = _host(shard(dist_join_2d(
            mesh, gs.split(lfk), (gs.split(ly),), gs.split(rpk), (gs.split(rx),),
            rounds=rounds), 0))

    res["multiproc"] = multiproc.rank_join(gs, sf=2, rows=MP_ROWS)
    res["multiproc_mesh"] = multiproc.rank_join(gs, sf=2, mesh=(2, 2), rounds=2, rows=MP_ROWS)
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rendezvous") / "group"
    return pg.spawn(_rank_cases, WORLD, init_method=f"file://{rdv}", device="cpu",
                    timeout_s=120)


def cpu_set(d):
    return DeviceSet([torch.device("cpu")] * d)


def canon(cols):
    rows = np.stack([np.asarray(c) for c in cols])
    return rows[:, np.lexsort(rows[::-1])]


def blocks(shards):
    return np.concatenate([s.numpy() for s in shards])


def _same_join(got, want_shard):
    """A rank's join outputs equal one shard of the one-controller join's."""
    fk, (y,), (x,), m, ovf = got
    wfk, (wy,), (wx,), wm, wovf = want_shard
    for a, b in ((fk, wfk), (y, wy), (x, wx), (m, wm), (ovf, wovf)):
        np.testing.assert_array_equal(a, b.numpy())


def _rows(outs):
    """The matched (fk, y, x) rows of every rank's outputs."""
    m = np.concatenate([o[3] for o in outs])
    return [np.concatenate([col for col in c])[m] for c in (
        [o[0] for o in outs], [o[1][0] for o in outs], [o[2][0] for o in outs])]


def _arrow_rows(left, right):
    expect = pa.Table.from_batches([b.to_arrow() for b in left]).join(
        pa.Table.from_batches([b.to_arrow() for b in right]),
        keys="fk", right_keys="pk", join_type="inner")
    return canon([expect[c].to_numpy() for c in ("fk", "y", "x")])


# ---- the exchange, gather and the shared decision -------------------------


def test_exchange_group_is_the_tiled_all_to_all(ranks):
    sent = [torch.arange(WORLD * 3 * 2, dtype=torch.int32).reshape(WORLD * 3, 2) + 100 * s
            for s in range(WORLD)]
    want = shuffle.exchange(sent)
    wide = shuffle.exchange([b.reshape(3, WORLD * 2) for b in sent], split_axis=1,
                            concat_axis=1)
    for t, r in enumerate(ranks):
        got, (copies, nbytes, colls) = r["exchange0"]
        np.testing.assert_array_equal(got, want[t].numpy())
        assert (copies, nbytes, colls) == (1, got.nbytes, 1)
        np.testing.assert_array_equal(r["exchange1"], wide[t].numpy())
        (via_set,) = r["set_exchange"]
        np.testing.assert_array_equal(via_set, want[t].numpy())


def test_exchange_group_calls_the_collective_at_world_1(ranks):
    for s, r in enumerate(ranks):
        got, (copies, nbytes, colls) = r["exchange_w1"]
        np.testing.assert_array_equal(got, (torch.arange(WORLD * 6, dtype=torch.int32)
                                            .reshape(WORLD * 3, 2) + 100 * s).numpy())
        assert colls == 1 and copies == 1 and nbytes == got.nbytes


def test_gather_and_any(ranks):
    want = np.concatenate([np.arange(s + 1, dtype=np.uint32) + 10 * s for s in range(WORLD)])
    np.testing.assert_array_equal(ranks[0]["gather"], want)
    assert ranks[0]["gather"].dtype == np.uint32
    assert all(r["gather"] is None for r in ranks[1:])
    assert all(r["any"] == (True, False) for r in ranks)


# ---- the flat shuffle ------------------------------------------------------


@pytest.mark.parametrize("d, rounds, inband", SHUFFLES)
def test_group_shuffle_equals_one_controller(ranks, d, rounds, inband):
    keys, pay, cell = _shuffle_inputs(d, rounds)
    ds = cpu_set(d)
    ref, (copies, nbytes, _) = _counted(lambda: shuffle.shuffle_partitions(
        ds.split(keys), (ds.split(pay),), d, cell, rounds=rounds, counts_inband=inband))
    got = [r[("shuffle", d, rounds, inband)] for r in ranks[:d]]
    for t, (k, p, c, o, rr, _) in enumerate(got):
        np.testing.assert_array_equal(k, ref[t].keys.numpy())
        np.testing.assert_array_equal(p, ref[t].payloads[0].numpy())
        np.testing.assert_array_equal(c, ref[t].counts.numpy())
        np.testing.assert_array_equal(o, ref[t].overflow.numpy())
        assert rr == rounds
    # the same copies and bytes in all, one collective a rank and exchange
    assert sum(g[5][0] for g in got) == copies and sum(g[5][1] for g in got) == nbytes
    assert all(g[5][2] == (1 if inband else 2) for g in got)
    assert all(("shuffle", d, rounds, inband) not in r for r in ranks[d:])


# ---- the join over a group -------------------------------------------------


@pytest.mark.parametrize("d, impl", JOINS)
def test_group_dist_join_matches_one_controller_jax_and_arrow(ranks, d, impl):
    import jax
    import jax.numpy as jnp

    from dpu_olap_tpu.parallel.dist_join import dist_join as jax_dist_join
    from dpu_olap_tpu.parallel.mesh import DeviceSet as JaxDeviceSet

    left, right, (lfk, ly, rpk, rx) = _tables()
    ref = dist_join(cpu_set(d), lfk, (ly,), rpk, (rx,), impl=impl)
    got = [r[("join", d, impl)] for r in ranks[:d]]
    for t, g in enumerate(got):
        _same_join(g, shard(ref, t))
    rows = _rows(got)
    assert len(rows[0]) == len(lfk)
    jfk, (jy,), (jx,), jm, jovf = jax_dist_join(
        JaxDeviceSet(jax.devices()[:d]), jnp.asarray(lfk), (jnp.asarray(ly),),
        jnp.asarray(rpk), (jnp.asarray(rx),), impl=impl)
    jm = np.asarray(jm)
    assert not np.asarray(jovf).any()
    np.testing.assert_array_equal(np.concatenate([g[3] for g in got]), jm)
    np.testing.assert_array_equal(canon(rows), canon([np.asarray(a)[jm] for a in (jfk, jy, jx)]))
    np.testing.assert_array_equal(canon(rows), _arrow_rows(left, right))


def test_group_dist_join_retries_skewed_keys(ranks):
    d, n = WORLD, WORLD * 1024
    fk, y, pk, x = _skewed(n, 3)
    cell = shuffle.default_cell_size(n // d, d, 2.0)
    first = dist_join(cpu_set(d), fk, (y,), pk, (x,))
    assert blocks(first[4]).any()  # the default cells overflow in some rank
    ref = dist_join(cpu_set(d), fk, (y,), pk, (x,), cell_left=2 * cell, cell_right=2 * cell)
    assert not blocks(ref[4]).any()
    assert all(r["retry"][1] == (2 * cell, 2 * cell) for r in ranks)
    got = [r["retry"][0] for r in ranks]
    for t, g in enumerate(got):
        _same_join(g, shard(ref, t))
    rows = _rows(got)
    assert len(rows[0]) == n
    np.testing.assert_array_equal(rows[2], x[rows[0]])
    np.testing.assert_array_equal(canon(rows[:2]), canon([fk, y]))


# ---- the 2 x 2 mesh over the group -----------------------------------------


def test_process_mesh_groups_ranks_as_jax_groups_by_process(ranks, monkeypatch):
    import jax

    from dpu_olap_tpu.parallel import multihost as jax_multihost

    class Device:  # a device of process `process_index`, as jax.distributed has
        def __init__(self, i, proc):
            self.id, self.process_index = i, proc

    monkeypatch.setattr(jax, "devices", lambda *a: [Device(r, r // 2) for r in range(WORLD)])
    grid = [[dev.id for dev in row] for row in jax_multihost.make_mesh_2d().devices]
    for r, got in enumerate(ranks):
        shape, host, chip, host_ranks, chip_ranks, host_pos, chip_pos = got["mesh"]
        assert shape == {"dcn": 2, "ici": 2} and grid[host][chip] == r
        assert list(host_ranks) == grid[host] and host_pos == chip
        assert list(chip_ranks) == [row[chip] for row in grid] and chip_pos == host


@pytest.mark.parametrize("rounds", [1, 2])
def test_group_shuffle_2d_equals_one_controller_and_flat(ranks, rounds):
    keys, pay, cell = _shuffle_inputs(WORLD, rounds)
    ds = cpu_set(WORLD)
    two = shuffle_partitions_2d(ds.split(keys), (ds.split(pay),), 2, 2, cell, rounds=rounds)
    for t, r in enumerate(ranks):
        k, p, c = r[("shuffle2d", rounds)]
        np.testing.assert_array_equal(k, two[t].keys.numpy())
        np.testing.assert_array_equal(p, two[t].payloads[0].numpy())
        np.testing.assert_array_equal(c, two[t].counts.numpy())
        np.testing.assert_array_equal(k, r[("shuffle", WORLD, rounds, False)][0])


@pytest.mark.parametrize("rounds", [1, 2])
def test_group_dist_join_2d_matches_one_controller_jax_and_arrow(ranks, rounds):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dpu_olap_tpu.parallel.multihost import DCN_AXIS, ICI_AXIS
    from dpu_olap_tpu.parallel.multihost import dist_join_2d as jax_dist_join_2d

    left, right, (lfk, ly, rpk, rx) = _tables()
    ref = dist_join_2d(make_mesh_2d(2, 2, ds=cpu_set(WORLD)), lfk, (ly,), rpk, (rx,),
                       rounds=rounds)
    got = [r[("join2d", rounds)] for r in ranks]
    for t, g in enumerate(got):
        _same_join(g, shard(ref, t))
    rows = _rows(got)
    jmesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), (DCN_AXIS, ICI_AXIS))
    jfk, (jy,), (jx,), jm, _ = jax_dist_join_2d(
        jmesh, jnp.asarray(lfk), (jnp.asarray(ly),), jnp.asarray(rpk), (jnp.asarray(rx),),
        rounds=rounds)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(np.concatenate([g[3] for g in got]), jm)
    np.testing.assert_array_equal(canon(rows), canon([np.asarray(a)[jm] for a in (jfk, jy, jx)]))
    np.testing.assert_array_equal(canon(rows), _arrow_rows(left, right))


# ---- bench/multiproc.py ----------------------------------------------------


@pytest.mark.parametrize("case", ["multiproc", "multiproc_mesh"])
def test_multiproc_rank_join(ranks, case):
    """rank_join's dense-truth verdict, and each rank's outputs equal the
    one-controller join's shard (their SHA-256)."""
    left, right = make_join_tables(2, MP_ROWS, MP_ROWS, seed=multiproc.SEED)
    lc, rc = left.concat(), right.concat()
    cols = (lc["fk"], (lc["y"],), rc["pk"], (rc["x"],))
    if case == "multiproc":
        ref = dist_join(cpu_set(WORLD), *cols, keys31=True)
    else:
        ref = dist_join_2d(make_mesh_2d(2, 2, ds=cpu_set(WORLD)), *cols, rounds=2)
    for t, r in enumerate(ranks):
        got = r[case]
        assert got["ok"] and got["rank"] == t and got["world"] == WORLD
        assert got["digest"] == multiproc.digest(*shard(ref, t)[:4])
        assert got["matched"] == int(ref[3][t].sum())
        assert got["launches"] == {"partition": 0, "sort": 0, "fill": 0, "gather": 0}
        assert got["exchange_bytes"] > 0 and got["collectives"] == (2 if case == "multiproc"
                                                                    else 4) * 2
        assert set(got["phase_ms"]) == {"fragments-ms", "exchange-ms", "local-join-ms"}
        assert got["exchange_ms"] == got["phase_ms"]["exchange-ms"] > 0
    assert sum(r[case]["matched"] for r in ranks) == lc.num_rows


def test_multiproc_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multiproc.main(["--nproc", "2"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multiproc.main(["--nproc", "2", "--backend", "nccl"]) == 1
    assert "NCCL takes one rank a card" in capsys.readouterr().err


# ---- set-up, failure and imports, without the spawn ------------------------


def test_init_group_needs_rank_and_rendezvous(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="needs rank and world_size"):
        pg.init_group("gloo", device="cpu")
    with pytest.raises(ValueError, match="needs init_method"):
        pg.init_group("gloo", rank=0, world_size=1, device="cpu")
    with pytest.raises(ValueError, match="NCCL runs on CUDA devices"):
        pg.init_group("nccl", rank=0, world_size=1, init_method="file:///nowhere", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pg.init_group(rank=0, world_size=1, init_method="file:///nowhere")


def _raises(gs):
    raise ValueError("rank failed on purpose")


def test_a_failed_rank_reports_its_traceback_and_exits(tmp_path):
    q = Queue()
    with pytest.raises(SystemExit) as exc:
        pg._rank_main(_raises, 0, 1, f"file://{tmp_path / 'rdv'}", "gloo", "cpu", 30, (), q)
    assert exc.value.code == 1
    rank, ok, tb = q.get_nowait()
    assert (rank, ok) == (0, False) and "rank failed on purpose" in tb
    assert not torch.distributed.is_initialized()  # the group was torn down


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import dpu_olap_tpu_torch.parallel.process_group, dpu_olap_tpu_torch.bench.multiproc\n"
            "import dpu_olap_tpu_torch.parallel.multihost, dpu_olap_tpu_torch.parallel.dist_join\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'dpu_olap_tpu' or m.startswith('dpu_olap_tpu.')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    for path in ("dpu_olap_tpu_torch/parallel/process_group.py",
                 "dpu_olap_tpu_torch/bench/multiproc.py", "chip_smoke.py"):
        text = (REPO / path).read_text()
        assert "import jax" not in text and "from jax" not in text
        assert "dpu_olap_tpu." not in text and "import dpu_olap_tpu\n" not in text


def test_retry_over_one_controller(monkeypatch):
    """The retry that JoinGpu runs: the same helper over a DeviceSet."""
    d, n = WORLD, WORLD * 1024
    fk, y, pk, x = _skewed(n, 3)
    cell = shuffle.default_cell_size(n // d, d, 2.0)
    out, cells = dist_join_retry(cpu_set(d), fk, (y,), pk, (x,))
    assert cells == (2 * cell, 2 * cell)
    ref = dist_join(cpu_set(d), fk, (y,), pk, (x,), cell_left=2 * cell, cell_right=2 * cell)
    for t in range(d):
        _same_join(_host(shard(out, t)), shard(ref, t))
    monkeypatch.setattr(dj, "RETRIES", 1)
    with pytest.raises(OverflowError, match="after retries"):
        dist_join_retry(cpu_set(d), fk, (y,), pk, (x,))
