"""``moe_ep`` with dropping and the mesh half of ``moe_decode`` at 4 ranks.

The port: 4 gloo processes (``torch_mesh_worker.py``, mesh data 2 x model
2, a file store), one MoE layer of tiny granite-moe in f32 with capacity
factor 0.5, so that tokens are dropped: ``moe_ep`` under the train rules
(the expert weights FSDP over data, gathered in the layer) and
``moe_decode`` under the serve rules.  The reference: the JAX package's
own ``moe_ep`` / ``moe_decode`` on a 4-device forced-host mesh, run in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) that
writes ``.npz``, while the ranks run.

Checks: the kept (token, expert) assignments of every rank are equal
(every router gap between the k-th and (k+1)-th probability here exceeds
1e-5, so routing is unambiguous); outputs within 1e-5 * max(1, |x|); aux
within 1e-6.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_mesh_worker import SRC, start_ranks, wait_ranks

MESH = {"data": 2, "model": 2}
B, S, B_DECODE = 4, 64, 8
CAPACITY_FACTOR = 0.5
TOL = 1e-5
AUX_TOL = 1e-6
MARGIN = 1e-5

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import base as cbase
from repro.configs.catalog import tiny
from repro.launch.mesh import make_test_mesh
from repro.models import moe
from repro.sharding import profiles, specs as sh

job_dir = sys.argv[1]
inp = np.load(os.path.join(job_dir, "inputs.npz"))
cfg = tiny(cbase.get_config("granite-moe-1b-a400m")).replace(
    dtype="float32", param_dtype="float32")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=float(sys.argv[2])))
m = cfg.moe
w = {k: jnp.asarray(inp["moe/" + k]) for k in
     ("router", "w_gate", "w_in", "w_out")}
x, xd = jnp.asarray(inp["moe/x"]), jnp.asarray(inp["moe/x_decode"])
mesh = make_test_mesh(data=2, model=2)
out = {}
with sh.use_mesh(mesh, profiles.rules_for(cfg, mesh, "train")):
    y, aux = jax.jit(lambda p, v: moe.moe_ep(m, p, v, cfg.act))(w, x)
out["ep_out"], out["ep_aux"] = np.asarray(y), np.asarray(aux)
# each rank's tokens: its rows over data, its positions over model
kept, margin = [], []
Bl, Sl = x.shape[0] // 2, x.shape[1] // 2
cap = max(8, -(-int(np.ceil(Bl * Sl * m.top_k / m.num_experts
                            * m.capacity_factor)) // 8) * 8)
for d in range(2):
    for e in range(2):
        t = x[d * Bl:(d + 1) * Bl, e * Sl:(e + 1) * Sl].reshape(-1, x.shape[2])
        gates, eidx, probs = moe.route(m, w["router"], t)
        _, _, _, keep, _ = moe._dispatch_local(m, t, gates, eidx, cap)
        kept.append(np.where(np.asarray(keep).reshape(eidx.shape),
                             np.asarray(eidx), -1))
        top = np.sort(np.asarray(probs), -1)[:, ::-1]
        margin.append(top[:, m.top_k - 1] - top[:, m.top_k])
out["ep_kept"], out["margin"] = np.stack(kept), np.stack(margin)
with sh.use_mesh(mesh, profiles.rules_for(cfg, mesh, "decode")):
    out["decode_out"] = np.asarray(jax.jit(
        lambda p, v: moe.moe_decode(m, p, v, cfg.act))(w, xd))
np.savez(os.path.join(job_dir, "jax.npz"), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job_dir = str(tmp_path_factory.mktemp("moe_ep"))
    rng = np.random.default_rng(0)
    D, E, F = 64, 4, 32           # tiny granite-moe: d_model, experts, d_ff

    def init(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    inputs = {"moe/router": init((D, E), D),
              "moe/w_gate": init((E, D, F), D),
              "moe/w_in": init((E, D, F), D),
              "moe/w_out": init((E, F, D), F),
              "moe/x": rng.standard_normal((B, S, D)).astype(np.float32),
              "moe/x_decode": rng.standard_normal(
                  (B_DECODE, 1, D)).astype(np.float32)}
    np.savez(os.path.join(job_dir, "inputs.npz"), **inputs)
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump({"mesh": MESH, "tasks": {"moe": {
            "kind": "moe", "arch": "granite-moe-1b-a400m",
            "dtype": "float32", "capacity_factor": CAPACITY_FACTOR}}}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, job_dir, str(CAPACITY_FACTOR)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = start_ranks(job_dir, 4)
    try:
        _, err = jax_proc.communicate(timeout=240)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        wait_ranks(procs)
    load = lambda n: dict(np.load(os.path.join(job_dir, n)))
    return load("jax.npz"), load("out.npz")


def test_routing_is_unambiguous(runs):
    ref, _ = runs
    assert ref["margin"].min() > MARGIN


def test_kept_assignments_equal(runs):
    ref, out = runs
    np.testing.assert_array_equal(out["moe/ep_kept"], ref["ep_kept"])


def test_tokens_are_dropped(runs):
    ref, out = runs
    dropped = float(np.mean(out["moe/ep_kept"] < 0))
    assert 0.05 < dropped < 0.95, dropped
    assert dropped == float(np.mean(ref["ep_kept"] < 0))


@pytest.mark.parametrize("what", ["ep_out", "decode_out"])
def test_outputs_match_jax(runs, what):
    ref, out = runs
    err = np.abs(out[f"moe/{what}"] - ref[what]) / np.maximum(
        1.0, np.abs(ref[what]))
    assert err.max() <= TOL, err.max()


def test_aux_matches_jax(runs):
    ref, out = runs
    assert abs(float(out["moe/ep_aux"]) - float(ref["ep_aux"])) <= AUX_TOL
