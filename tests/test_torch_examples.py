"""The port's examples (``repro_torch.examples``) on the CPU, each run with
``--device cpu`` at its own sizes, against the reference's examples and
the JAX package:

* ``elastic_hot_spares``: the three policy rows equal, field for field,
  those of ``examples/elastic_hot_spares.simulate`` at the same seed (the
  reference example loaded by path; nothing in it is edited);
* ``quickstart``: the counter reads 2000; the Fig. 1 slots equal the
  reference DES's own, exactly (ROADMAP.md C13: spin 3.x, sleep 5.0,
  mutable 3.0); the 8 train losses are finite and fall; 6 requests
  complete;
* ``serve_continuous_batching``: every policy completes all 12 requests;
* ``train_resume``: 19 resumed losses (steps 11–29, ROADMAP.md C14), each
  within 1e-5 of an uninterrupted run's.
"""

from __future__ import annotations

import importlib.util
import math
import os

import pytest

from repro.core.des import simulate as jsimulate
from repro_torch.examples import (elastic_hot_spares, quickstart,
                                  serve_continuous_batching, train_resume)
from repro_torch.launch import train as LT

HERE = os.path.dirname(os.path.abspath(__file__))
#: C14's tolerance on a resumed loss, relative.
RESUME_RTOL = 1e-5


def reference_example(name: str):
    path = os.path.join(os.path.dirname(HERE), "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_elastic_hot_spares_rows_equal_the_reference():
    ref = reference_example("elastic_hot_spares")
    rows = elastic_hot_spares.main(["--device", "cpu"])
    assert list(rows) == list(elastic_hot_spares.POLICIES)
    for policy, row in rows.items():
        assert row == ref.simulate(policy), policy


@pytest.fixture(scope="module")
def quick():
    return quickstart.main(["--device", "cpu"])


def test_quickstart_lock_and_fig1(quick):
    assert quick["counter"] == 2000
    unit = 10e-6
    for kind, kw in (("ttas", {}), ("sleep", {}),
                     ("mutable", {"initial_sws": 2})):
        r = jsimulate(kind, threads=3, cores=3, cs=(unit, unit),
                      ncs=(1e-9, 1e-9), wake_latency=unit, target_cs=3,
                      max_cs_per_thread=1, seed=1, lock_kwargs=kw)
        assert quick["fig1"][kind] == r.t_end / unit, kind
    # as printed: spin 3.x, sleep 5.0, mutable 3.0 (the paper: 3 / 5 / 3)
    assert [f"{quick['fig1'][k]:.1f}" for k in ("sleep", "mutable")] == \
        ["5.0", "3.0"]
    assert 3.0 <= quick["fig1"]["ttas"] < 4.0


def test_quickstart_train_and_serve(quick):
    losses = quick["losses"]
    assert len(losses) == quickstart.TRAIN_STEPS
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert quick["serve"]["completed"] == quickstart.REQUESTS


def test_serve_continuous_batching_completes_every_policy():
    out = serve_continuous_batching.main(["--device", "cpu"])
    assert list(out) == list(serve_continuous_batching.POLICIES)
    for policy, summary in out.items():
        assert summary["completed"] == serve_continuous_batching.REQUESTS, \
            policy


def test_train_resume_matches_an_uninterrupted_run():
    out = train_resume.main(["--device", "cpu"])
    assert out["died"]["died_at"] == train_resume.FAIL_AT
    got = out["resumed"]["losses"]
    assert len(got) == 19 == len(train_resume.RESUMED)
    whole = LT.main(train_resume.ARGV + ["--device", "cpu"])["losses"]
    want = whole[train_resume.RESUMED.start:]
    for a, b in zip(got, want, strict=True):
        assert abs(a - b) <= RESUME_RTOL * abs(b)
