"""The port's mesh path on 8 gloo ranks: the reference's distributed checks.

One spawn of 8 CPU processes (``torch_mesh_worker.py``; mesh pod 2 x data
2 x model 2; a file store, no port; one thread each) runs, with the
weights carried from JAX:

* one sharded train step of tiny llama3.2-1b under the train rules (TP
  over model, FSDP over data, DP over pod x data), and its gradients;
* one int8 error-feedback compressed step (per-pod gradients, int8 sums
  over pod), and the int8 reduction alone from a residual carried in:
  the dequantized sums and each pod's new residual;
* prefill and 10 decode steps from an empty cache under the serve rules
  (the mesh branch of ``decode_attention_cp``: the cache's positions split
  over model);
* one train step of tiny granite-moe with a capacity factor (4.0) under
  which nothing drops, so ``moe_ep`` runs in training;
* the llama step again with ``seqcarry=model`` and remat full: the
  residual stream between layers split over its sequence, each layer
  recomputed in the backward; with ``kvheads`` unsplit (the query heads
  split, every rank taking its groups of the whole k / v), in training
  and decode; the granite step at 31 positions, which the model axis
  does not divide (``moe_ep`` then sends every rank's copy of the tokens,
  each expert's gradient scaled back).

Against the JAX package's one-device jitted step, prefill and decode, at
``tests/test_distributed.py``'s tolerances (loss 5e-2, params atol = rtol
= 3e-2; int8 loss and params 5e-2; logits 5e-2); against the port's own
one-device runs in f32 at the tolerances below.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import base as jcb
from repro.configs.catalog import tiny as jtiny
from repro.configs.inputs import concrete_batch
from repro.sharding.specs import _path_str
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import models
from repro_torch.configs import base as cbase
from repro_torch.configs.catalog import tiny
from repro_torch.models import convert
from repro_torch.train import TrainConfig, make_train_step, state_of
from repro_torch.train import train_step as ts
from torch_mesh_worker import start_ranks, wait_ranks

MESH = {"data": 2, "model": 2, "pod": 2}
WORLD = 8
#: The port on the mesh against the port on one device, f32: parameters
#: after a step and losses within PORT_TOL * max(1, |x|); gradients
#: within PORT_TOL * max(1, max|g| of the leaf); logits within PORT_TOL *
#: max(1, |x|).  The mesh sums in another order (partial products summed
#: over ranks, the vocabulary's log-softmax by blocks).
PORT_TOL = 1e-5
#: AdamW's first update of an element is lr * g / (|g| + eps) in effect:
#: where |g| is near eps or near the summation-order noise, that noise
#: moves the update by a share of lr.  As in test_torch_train_step.py,
#: such elements are held to 3 * lr instead, and must be at most
#: ADAM_SHARE of all.
ADAM_SHARE = 0.02
GRANITE_CF = 4.0
PROMPT, STEPS, MAX_SEQ = 8, 10, 16
#: Positions the model axis (2) does not divide.
ODD_SEQ = 31


def flat_numpy(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(v, np.float32) for p, v in leaves}


def port_cfg(name, capacity_factor=None):
    cfg = tiny(cbase.get_config(name)).replace(dtype="float32",
                                               param_dtype="float32")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def port_model(cfg, flat):
    model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    convert.load_leaves(cfg, model, flat)
    return model


def port_step(cfg, flat, batch):
    """The port's one-device step: (params by path, metrics, grads)."""
    tcfg = TrainConfig(warmup_steps=2, decay_steps=20, seed=0)
    model = state_of(cfg, tcfg, port_model(cfg, flat))["params"]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, grads = ts._grads_plain(cfg, model, batch)
    state = state_of(cfg, tcfg, port_model(cfg, flat))
    state, metrics = make_train_step(cfg, tcfg)(state, batch)
    params = {k: convert.stack_leaf(v).numpy() for k, v in
              convert.param_leaves(cfg, state["params"]).items()}
    return params, {k: float(v) for k, v in metrics.items()}, \
        {k: g.numpy() for k, g in grads.items()}


def port_pod_grads(cfg, flat, batch):
    """The port's one-device gradients of each pod's rows (the mesh splits
    the batch's rows over pod x data, pod major)."""
    rows = next(iter(batch.values())).shape[0] // MESH["pod"]
    model = state_of(cfg, TrainConfig(), port_model(cfg, flat))["params"]
    out = []
    for p in range(MESH["pod"]):
        part = {k: torch.from_numpy(v[p * rows:(p + 1) * rows])
                for k, v in batch.items()}
        out.append({k: g.numpy() for k, g in
                    ts._grads_plain(cfg, model, part)[2].items()})
    return out


def port_decode(cfg, flat, prompts, steps):
    model = port_model(cfg, flat)
    with torch.no_grad():
        pre, _ = models.prefill(cfg, model, {"tokens": prompts})
        cache = models.init_cache(cfg, prompts.shape[0], MAX_SEQ, "cpu")
        seen = []
        for t in range(steps.shape[1]):
            logits, cache = models.decode_step(cfg, model, cache,
                                               steps[:, t:t + 1])
            seen.append(logits.numpy())
    return pre.numpy(), np.stack(seen, 1)


def jax_decode(cfg, params, prompts, steps):
    pre, _ = jax.jit(lambda p, t: jm.prefill(cfg, p, {"tokens": t}))(
        params, prompts)
    cache = jm.init_cache(cfg, prompts.shape[0], max_seq=MAX_SEQ)
    step = jax.jit(lambda p, c, t: jm.decode_step(cfg, p, c, t))
    seen = []
    for t in range(steps.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(steps[:, t:t + 1]))
        seen.append(np.asarray(logits, np.float32))
    return np.asarray(pre, np.float32), np.stack(seen, 1)


def ref_cfg(name, dtype):
    cfg = jtiny(jcb.get_config(name)).replace(dtype=dtype, param_dtype=dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=GRANITE_CF))
    return cfg


#: (task, arch, kind, dtype, extra): the bf16 tasks (the reference's
#: configs) are held against JAX, the f32 ones against the port.
TASKS = (
    ("train", "llama3.2-1b", "train", "bfloat16", {}),
    ("int8", "llama3.2-1b", "train", "bfloat16", {"compression": "int8"}),
    ("serve", "llama3.2-1b", "decode", "bfloat16", {}),
    ("granite", "granite-moe-1b-a400m", "train", "bfloat16", {}),
    ("train32", "llama3.2-1b", "train", "float32", {}),
    ("int8_32", "llama3.2-1b", "train", "float32", {"compression": "int8"}),
    ("serve32", "llama3.2-1b", "decode", "float32", {}),
    ("granite32", "granite-moe-1b-a400m", "train", "float32", {}),
    ("carry32", "llama3.2-1b", "train", "float32",
     {"overrides": {"seqcarry": "model"}, "remat": "full"}),
    ("kvrep32", "llama3.2-1b", "train", "float32",
     {"overrides": {"kvheads": None}}),
    ("serve_kvrep32", "llama3.2-1b", "decode", "float32",
     {"overrides": {"kvheads": None}}),
    ("granite_odd32", "granite-moe-1b-a400m", "train", "float32",
     {"seq": ODD_SEQ}),
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job_dir = str(tmp_path_factory.mktemp("mesh"))
    jtcfg = JTrainConfig(warmup_steps=2, decay_steps=20, seed=0)
    inputs, ref = {}, {}
    for arch, key in (("llama3.2-1b", 0), ("granite-moe-1b-a400m", 2)):
        for dtype in ("bfloat16", "float32"):
            cfg = ref_cfg(arch, dtype)
            state0 = jinit_state(cfg, jtcfg, jax.random.PRNGKey(key))
            batch = concrete_batch(cfg, 8, 32, jax.random.PRNGKey(key + 1))
            r = ref[(arch, dtype)] = {
                "cfg": cfg, "state0": state0, "batch": batch,
                "flat": flat_numpy(state0["params"])}
            inputs.update({f"{arch}/{dtype}/{k}": v
                           for k, v in r["flat"].items()})
        inputs.update({f"{arch}/batch/{k}": np.asarray(batch[k], np.int64)
                       for k in ("tokens", "labels")})
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (8, PROMPT))
    steps = rng.integers(0, 256, (8, STEPS))
    inputs["serve/prompts"], inputs["serve/steps"] = prompts, steps
    np.savez(os.path.join(job_dir, "inputs.npz"), **inputs)
    tasks = {}
    for name, arch, kind, dtype, extra in TASKS:
        tasks[name] = dict(kind=kind, arch=arch, dtype=dtype,
                           params=f"{arch}/{dtype}", **extra)
        if kind == "train":
            tasks[name]["batch"] = f"{arch}/batch"
            if arch.startswith("granite"):
                tasks[name]["capacity_factor"] = GRANITE_CF
        else:
            tasks[name].update(batch="serve", max_seq=MAX_SEQ)
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump({"mesh": MESH, "tasks": tasks}, f)
    procs = start_ranks(job_dir, WORLD)
    try:
        # the references, while the ranks run
        for (arch, dtype), r in ref.items():
            if dtype == "bfloat16":
                st, m = jax.jit(jmake_train_step(r["cfg"], jtcfg))(
                    r["state0"], r["batch"])
                r["jax_params"] = flat_numpy(st["params"])
                r["jax_loss"] = float(m["loss"])
            else:
                b = {k: np.asarray(r["batch"][k], np.int64)
                     for k in ("tokens", "labels")}
                cfg = port_cfg(arch, GRANITE_CF if "moe" in arch else None)
                r["port_params"], r["port_metrics"], r["port_grads"] = \
                    port_step(cfg, r["flat"], b)
                r["pod_grads"] = port_pod_grads(cfg, r["flat"], b)
                if "moe" in arch:
                    r["odd"] = port_step(cfg, r["flat"], {
                        k: v[:, :ODD_SEQ] for k, v in b.items()})
        r = ref[("llama3.2-1b", "bfloat16")]
        r["jax_prefill"], r["jax_decode"] = jax_decode(
            r["cfg"], r["state0"]["params"], jnp.asarray(prompts), steps)
        r = ref[("llama3.2-1b", "float32")]
        r["port_prefill"], r["port_decode"] = port_decode(
            port_cfg("llama3.2-1b"), r["flat"], torch.from_numpy(prompts),
            torch.from_numpy(steps))
    finally:
        wait_ranks(procs)
    out = np.load(os.path.join(job_dir, "out.npz"))
    return ref, {k: out[k] for k in out.files}


def within(got, want, tol):
    """max |got - want| / max(1, |want|) elementwise, <= tol."""
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    return float(err.max()), float(err.max()) <= tol


LLAMA16 = ("llama3.2-1b", "bfloat16")
LLAMA32 = ("llama3.2-1b", "float32")
ARCH = {"train": LLAMA16, "granite": ("granite-moe-1b-a400m", "bfloat16"),
        "train32": LLAMA32, "granite32": ("granite-moe-1b-a400m", "float32"),
        "carry32": LLAMA32, "kvrep32": LLAMA32,
        "granite_odd32": ("granite-moe-1b-a400m", "float32")}


def port_ref(ref, name):
    """(params, metrics, grads) of the port's one-device step for task
    ``name``."""
    r = ref[ARCH[name]]
    if name == "granite_odd32":
        return r["odd"]
    return r["port_params"], r["port_metrics"], r["port_grads"]


PORT_TRAIN = ["train32", "granite32", "carry32", "kvrep32", "granite_odd32"]


@pytest.mark.parametrize("name", ["train", "granite"])
def test_sharded_step_matches_jax_one_device(runs, name):
    ref, out = runs
    r = ref[ARCH[name]]
    assert abs(float(out[f"{name}/loss"]) - r["jax_loss"]) < 5e-2
    for k, want in r["jax_params"].items():
        np.testing.assert_allclose(out[f"{name}/p/{k}"], want, atol=3e-2,
                                   rtol=3e-2, err_msg=k)


@pytest.mark.parametrize("name", PORT_TRAIN)
def test_sharded_grads_match_port_one_device(runs, name):
    ref, out = runs
    for k, want in port_ref(ref, name)[2].items():
        got = out[f"{name}/g/{k}"]
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= PORT_TOL * scale, k


@pytest.mark.parametrize("name", PORT_TRAIN)
def test_sharded_step_matches_port_one_device(runs, name):
    ref, out = runs
    params, metrics, _ = port_ref(ref, name)
    for k in ("loss", "ce", "aux", "grad_norm"):
        err, ok = within(float(out[f"{name}/{k}"]), metrics[k], PORT_TOL)
        assert ok, (k, err)
    loose = total = 0
    for k, want in params.items():
        diff = np.abs(out[f"{name}/p/{k}"] - want)
        over = diff > PORT_TOL * np.maximum(1.0, np.abs(want))
        assert (diff[over] <= 3 * metrics["lr"]).all(), (k, diff.max())
        loose, total = loose + int(over.sum()), total + diff.size
    assert loose <= ADAM_SHARE * total, (loose, total)


def test_int8_compressed_step_tracks_uncompressed(runs):
    ref, out = runs
    r = ref[LLAMA16]
    assert abs(float(out["int8/loss"]) - r["jax_loss"]) < 5e-2
    errs = [np.abs(out[f"int8/p/{k}"] - want).max()
            for k, want in r["jax_params"].items()]
    assert max(errs) < 5e-2, max(errs)
    # the carried residual: at most half a quantization step of a leaf
    assert 0.0 < float(out["int8/ef_max"]) < 1.0


def test_int8_loss_is_the_pods_mean(runs):
    ref, out = runs
    err, ok = within(float(out["int8_32/loss"]),
                     ref[LLAMA32]["port_metrics"]["loss"], PORT_TOL)
    assert ok, err


def test_int8_reduction_quantizes_the_pods_gradients(runs):
    """The int8 reduction alone, from a residual carried in: each pod's
    gradient (the port's one-device gradient of its rows) plus its carried
    residual, g_in, is quantized on one grid a leaf, max|g_in| over the
    pods / 127; each pod's new residual is what its int8 values leave of
    g_in (at most half a step, the rest a whole number of steps), and the
    result is the mean of those values over the pods: within half a step
    of the uncompressed gradient plus the mean residual carried in.  The
    step's grad_norm (nothing carried in) lies within the norm of those
    half-steps of the uncompressed one."""
    ref, out = runs
    r = ref[LLAMA32]
    half_sq = 0.0
    for k, full in r["port_grads"].items():
        pods = np.stack([g[k] for g in r["pod_grads"]])
        prev = out[f"int8_32/ef_prev/{k}"]
        g_in = pods + prev
        deq, ef = out[f"int8_32/g/{k}"], out[f"int8_32/ef/{k}"]
        scale = float(np.abs(g_in).max()) / 127.0
        noise = PORT_TOL * max(1.0, float(np.abs(g_in).max()))
        local = g_in - ef                   # each pod's int8 values x scale
        steps = local / scale
        assert np.abs(ef).max() <= scale / 2 + noise, k
        assert (np.abs(steps - np.round(steps)) * scale).max() <= noise, k
        assert np.abs(np.round(steps)).max() <= 127, k
        assert np.abs(local.mean(0) - deq).max() <= noise, k
        assert np.abs(deq - (full + prev.mean(0))).max() \
            <= scale / 2 + noise, k
        half_sq += full.size * (float(np.abs(pods).max()) / 254.0) ** 2
    gnorm = r["port_metrics"]["grad_norm"]
    assert abs(float(out["int8_32/grad_norm"]) - gnorm) <= \
        np.sqrt(half_sq) + PORT_TOL * max(1.0, gnorm)


@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_cp_decode_matches_jax_one_device(runs, what):
    ref, out = runs
    np.testing.assert_allclose(out[f"serve/{what}"],
                               ref[LLAMA16][f"jax_{what}"], atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("name", ["serve32", "serve_kvrep32"])
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_cp_decode_matches_port_one_device(runs, name, what):
    ref, out = runs
    err, ok = within(out[f"{name}/{what}"], ref[LLAMA32][f"port_{what}"],
                     PORT_TOL)
    assert ok, err
