"""The frozen generators and planner of the benchmark equal the program's
catalog and planner today, at small sizes; the work of a sweep does not
depend on the run's seed."""

import numpy as np
import pytest

from portbench import traffic as TR

catalog = pytest.importorskip("repro_torch.configs.catalog")
policy = pytest.importorskip("repro_torch.core.policy")
xdes = pytest.importorskip("repro_torch.core.xdes")


def _same_columns(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("n,seed", [(1, 0), (37, 0), (25, 3)])
def test_sampler_equals_catalog(n, seed):
    _same_columns(TR.sample_scenario_columns(n, seed),
                  catalog.sample_scenario_columns(n, seed))


def test_discipline_columns_equal_catalog():
    cfg = TR.load_json("configs", "discipline_oracle")
    want = catalog.lock_discipline_columns(12, 5)
    assert [(v["lock"], v["oracle"]) for v in cfg["variants"]] == \
        [(v["lock"], v["oracle"]) for v in catalog.lock_discipline_variants()]
    got = TR.build(cfg, {"design": "sampled", "scenarios": 12,
                         "design_seed": 5}).cols
    _same_columns(got, want)


def test_arrival_columns_equal_catalog():
    cfg = TR.load_json("configs", "arrival_slo")
    ol = cfg["open_loop"]
    assert (tuple(ol["arrivals"]), tuple(ol["rhos"])) == \
        (catalog.LOCK_ARRIVALS, catalog.LOCK_ARRIVAL_RHOS)
    got = TR.build(cfg, {"design": "sampled", "scenarios": 3,
                         "design_seed": 2}).cols
    _same_columns(got, catalog.lock_arrival_columns(3, 2))


def test_paper_grid_equals_fig3():
    """The paper design with the fig. 3 disciplines reproduces the
    catalog's fig. 3 grid (its rows reordered to regime, threads, seed,
    lock)."""
    tr = TR.load_json("traffic", "paper-regimes-100k")
    assert tr["regimes"] == {k: [v[0][1], v[1][1]]
                             for k, v in catalog.LOCK_REGIMES.items()}
    assert tuple(tr["threads"]) == catalog.LOCK_THREADS
    assert (tr["cores"], tr["wake"]) == (catalog.LOCK_CORES,
                                        catalog.LOCK_WAKE)
    regimes = {k: tuple(v) for k, v in tr["regimes"].items()}
    sc, _ = TR.paper_scenario_columns(regimes, tr["threads"], tr["cores"],
                                      tr["wake"], 2)
    locks = catalog.LOCK_DISCIPLINES
    got = TR.product_columns(sc, [dict(lock=l) for l in locks])
    want = policy.config_columns(catalog.lock_fig3_grid(seeds=(0, 1)))
    # want: regime, lock, threads, seed; got: seed, regime, threads, lock
    R, L, Th, S = len(regimes), len(locks), len(tr["threads"]), 2
    order = np.arange(R * L * Th * S).reshape(R, L, Th, S) \
        .transpose(3, 0, 2, 1).reshape(-1)
    for k in ("lock", "threads", "cores", "cs_lo", "cs_hi", "ncs_lo",
              "ncs_hi", "wake_latency", "seed", "oracle", "workload"):
        np.testing.assert_array_equal(
            np.asarray(got[k]).astype(np.float64),
            np.asarray(want[k])[order].astype(np.float64), err_msg=k)
    # alpha: the fig. 3 grid leaves it to each lock's default
    enc_got = policy.encode_columns(got)
    enc_want = policy.encode_columns({k: np.asarray(v)[order]
                                      for k, v in want.items()})
    np.testing.assert_array_equal(enc_got["alpha"], enc_want["alpha"])


@pytest.mark.parametrize("name", ["sampled-100k", "arrival-sampled-100k"])
def test_planner_equals_program(name):
    cfg = TR.load_json("configs", "arrival_slo" if "arrival" in name
                       else "discipline_oracle")
    tr = dict(TR.load_json("traffic", name), scenarios=40)
    cols = TR.build(cfg, tr).cols
    dt, steps = TR.plan(cols, 150)
    dt2, steps2 = xdes.plan_schedule_columns(cols, 150)
    np.testing.assert_array_equal(dt, dt2)
    np.testing.assert_array_equal(steps, steps2)


def test_encode_row_equals_program():
    cfg = TR.load_json("configs", "arrival_slo")
    cols = TR.build(cfg, {"design": "sampled", "scenarios": 2,
                          "design_seed": 9}).cols
    enc = policy.encode_columns(cols)
    dt, _ = TR.plan(cols, 150)
    for i in range(0, len(cols["lock"]), 7):
        row = TR.encode_row(cols, i, dt[i])
        for k, v in row.items():
            if k == "dt":
                continue
            want = enc[k][i]
            assert v == want and type(np.asarray(v).item()) is \
                type(np.asarray(want).item()), (k, v, want)


@pytest.mark.parametrize("name,configs,cells", [
    ("sampled-100k", 100_005, 12), ("arrival-sampled-100k", 100_080, 8),
    ("paper-regimes-100k", 99_840, 32), ("sampled-400k", 400_020, 12)])
def test_cell_sizes(name, configs, cells):
    cfg = TR.load_json("configs", "arrival_slo" if "arrival" in name
                       else "discipline_oracle")
    sw = TR.build(cfg, TR.load_json("traffic", name))
    assert sw.n_configs == configs
    assert len(sw.cell_names) == cells
    assert len(sw.cell_ids) * sw.group == configs


def test_400k_starts_with_the_100k_design():
    small = TR.sample_scenario_columns(6667, 0)
    big = TR.sample_scenario_columns(26668, 0)
    for k in small:
        np.testing.assert_array_equal(small[k], big[k][:6667])


def test_seed_moves_only_the_random_streams():
    cfg = TR.load_json("configs", "discipline_oracle")
    sw = TR.build(cfg, {"design": "sampled", "scenarios": 30,
                        "design_seed": 0})
    a, b = sw.with_seed(2 ** 31 + 17, 0), sw.with_seed(7, 3)
    assert not np.array_equal(a["seed"], b["seed"])
    for k in sw.cols:
        if k != "seed":
            np.testing.assert_array_equal(a[k], b[k])
    for cols in (a, b):
        np.testing.assert_array_equal(TR.plan(cols, 150)[1],
                                      TR.plan(sw.cols, 150)[1])
    assert a["seed"].dtype == np.uint32
