"""The port's serving path (``repro_torch.serve``) against the JAX
package's (``repro.serve``) on the CPU: the same tiny llama (JAX's
parameters carried over), the same requests, each admission policy; every
request's generated tokens and the scheduler's statistics must be
identical.  Also the simulated engine under load, and the port's CLI.
"""

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import base as jbase
from repro.configs import catalog as jcatalog
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import SimulatedEngine as JSim
from repro_torch.configs import base as tbase
from repro_torch.configs import catalog as tcatalog
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.serve import ContinuousBatcher, DecodeEngine, Request
from repro_torch.serve import SimulatedEngine

torch.set_num_threads(1)

SLOTS, MAX_SEQ, MAX_NEW, N_REQ = 3, 32, 6, 8


@pytest.fixture(scope="module")
def tiny_llama():
    jcfg = jcatalog.tiny(jbase.get_config("llama3.2-1b")).replace(
        dtype="float32", param_dtype="float32")
    tcfg = tcatalog.tiny(tbase.get_config("llama3.2-1b")).replace(
        dtype="float32", param_dtype="float32")
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, np_params, {}


def _prompts(vocab, seed=0):
    """Seeded prompts of two lengths (each length compiles one JAX
    prefill)."""
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, vocab - 1,
                                       size=int(rng.choice([5, 9])))))
            for _ in range(N_REQ)]


def _drain(batcher_cls, engine, req_cls, policy, prompts):
    bat = batcher_cls.from_policy(engine, policy)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        bat.submit(r)
    stats = bat.run_until_drained(max_steps=500)
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("policy", ["mutable", "zero", "max"])
def test_engine_and_batcher_match_jax(tiny_llama, policy):
    jcfg, tcfg, params, np_params, jitted = tiny_llama
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, params, max_slots=SLOTS, max_seq=MAX_SEQ)
    if jitted:       # one compile of each JAX function for all policies
        jeng._prefill, jeng._decode = jitted["prefill"], jitted["decode"]
    jitted.update(prefill=jeng._prefill, decode=jeng._decode)
    teng = DecodeEngine(tcfg, convert.params_from_numpy(tcfg, np_params,
                                                         "cpu"),
                        max_slots=SLOTS, max_seq=MAX_SEQ, device="cpu")
    jtoks, jstats = _drain(JBatcher, jeng, JRequest, policy, prompts)
    ttoks, tstats = _drain(ContinuousBatcher, teng, Request, policy, prompts)
    assert ttoks == [[int(t) for t in g] for g in jtoks]
    assert all(len(g) == MAX_NEW for g in ttoks)
    assert tstats.summary() == jstats.summary()
    assert tstats.window_trace == jstats.window_trace
    assert len(teng.prefill_seconds) == N_REQ
    assert len(teng.step_seconds) == tstats.steps
    # the caches agree after the drain, garbage slots included
    want = jax.tree.map(np.asarray, jeng.cache)
    got = convert.cache_to_numpy(tcfg, teng.cache)
    np.testing.assert_array_equal(got["len"], want["len"])
    for name in ("k", "v"):
        np.testing.assert_allclose(got["stack"][0][name],
                                   want["stack"][0][name], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("policy", ["mutable", "zero", "max", "sleep",
                                    "spin"])
def test_batcher_on_simulated_engine_matches_jax(policy):
    rng = np.random.default_rng(1)
    prompts = [[1] * int(n) for n in rng.integers(1, 40, 60)]
    jtoks, jstats = _drain(JBatcher, JSim(max_slots=4), JRequest, policy,
                           prompts)
    ttoks, tstats = _drain(ContinuousBatcher, SimulatedEngine(max_slots=4),
                           Request, policy, prompts)
    assert ttoks == jtoks
    assert tstats.summary() == jstats.summary()
    assert tstats.window_trace == jstats.window_trace


def test_queue_cap_sheds_like_jax():
    jbat = JBatcher(JSim(max_slots=2), queue_cap=3)
    tbat = ContinuousBatcher(SimulatedEngine(max_slots=2), queue_cap=3)
    got = [tbat.submit(Request(i, [1], 2)) for i in range(6)]
    want = [jbat.submit(JRequest(i, [1], 2)) for i in range(6)]
    assert got == want == [True] * 3 + [False] * 3
    assert tbat.stats.summary() == jbat.stats.summary()


def test_serve_cli_runs_on_cpu(capsys):
    s = tserve.main(["--tiny", "--device", "cpu", "--requests", "5",
                     "--slots", "2", "--max-new", "4"])
    assert s["completed"] == 5
    out = capsys.readouterr().out
    assert "served 5 requests / 20 tokens" in out and "window trace" in out


def test_serve_tokens_in_vocab_and_seeded():
    args = tserve.parse_args(["--tiny", "--device", "cpu", "--requests", "3",
                              "--slots", "2", "--max-new", "3",
                              "--policy", "max"])
    runs = []
    for _ in range(2):
        cfg, engine = tserve.build(args)
        out = tserve.run(args, cfg, engine)
        runs.append([r.generated for r in out["requests"]])
        assert all(0 <= t < cfg.vocab_size for g in runs[-1] for t in g)
    assert runs[0] == runs[1]
