"""The rest of the port's mesh path on 8 gloo ranks: the rwkv6 and mamba
mixers, the encoder-decoder, Adafactor and decode on a cache split over its
kv heads.

One spawn of 8 CPU processes (``torch_mesh_worker.py``; mesh pod 2 x data
2 x model 2; a file store, no port; one thread each) runs, with the
weights carried from JAX, in f32:

* tiny rwkv6-1.6b: one train step (AdamW) under the train rules, then
  prefill and decode steps on from the prefill's cache under the serve
  rules (K6 on the rank's heads, ``w_o`` and the channel-mix's ``w_v``
  row-parallel, ``wkv`` split over ``heads``);
* tiny jamba: the same (mamba's ``in_proj`` product gathered and split
  into each half's channel block, the gated norm on gathered channels,
  ``conv`` / ``ssm`` over ``ffn``; MoE at a capacity factor under which
  nothing drops);
* tiny qwen3-moe: one Adafactor step, its factored moments ``v_row`` /
  ``v_col`` too (means summed over the axes that split their dims);
* tiny llama served at a ``max_seq`` that the model axis does not divide,
  so decode runs on a cache split over its kv heads;
* tiny whisper with 4 heads (split over model) and with 3 (whole on every
  rank): one train step, then prefill and decode.  The same attention
  ``replace`` goes on both packages' configs.

Against the JAX package's one-device jitted runs at
``tests/test_distributed.py``'s tolerances (loss 5e-2, params and
Adafactor's moments atol = rtol = 3e-2, logits 5e-2), and against the
port's own one-device runs at ``test_torch_mesh.py``'s PORT_TOL with its
AdamW sign rule.  Logits are held to PORT_TOL or to ROUNDING x the
distance between the port's and JAX's one-device runs of the same
inputs, whichever is larger: that distance is the f32 rounding of the
model's depth (1.2e-5 on tiny jamba's 16 layers), and the mesh sums in a
third order.
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
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import models
from repro_torch.models import convert
from repro_torch.train import TrainConfig, make_train_step, state_of
from repro_torch.train import train_step as ts
from test_torch_mesh import (ADAM_SHARE, PORT_TOL, flat_numpy, port_model,
                             within)
from torch_mesh_worker import arch_cfg, start_ranks, wait_ranks, widen

MESH = {"data": 2, "model": 2, "pod": 2}
WORLD = 8
CF = 4.0
BATCH, SEQ = 8, 32
PROMPT, STEPS, MAX_SEQ = 8, 10, 24
#: Decode slots the model axis (2) does not divide: the serve rules then
#: split the cache over its kv heads.
ODD_SEQ = 19
#: Serve logits against the port's one-device run: within PORT_TOL, or
#: within ROUNDING x the two one-device runs' own distance where that is
#: larger.
ROUNDING = 2.0
#: (variant, arch, attention fields replaced, seed)
VARIANTS = {
    "rwkv6": ("rwkv6-1.6b", None, 10),
    "jamba": ("jamba-1.5-large-398b", None, 11),
    "qwen3": ("qwen3-moe-235b-a22b", None, 12),
    "llama": ("llama3.2-1b", None, 13),
    "whisper4": ("whisper-large-v3", None, 14),
    "whisper3": ("whisper-large-v3", {"num_heads": 3, "num_kv_heads": 3},
                 15),
}
#: (task, variant, kind, extra)
TASKS = (
    ("rwkv6_train", "rwkv6", "train", {}),
    ("rwkv6_serve", "rwkv6", "serve", {"max_seq": MAX_SEQ}),
    ("jamba_train", "jamba", "train", {}),
    ("jamba_serve", "jamba", "serve", {"max_seq": MAX_SEQ}),
    ("qwen3_adafactor", "qwen3", "train", {"optimizer": "adafactor"}),
    ("llama_kvheads", "llama", "serve", {"max_seq": ODD_SEQ}),
    ("whisper4_train", "whisper4", "train", {}),
    ("whisper4_serve", "whisper4", "serve", {"max_seq": MAX_SEQ}),
    ("whisper3_train", "whisper3", "train", {}),
    ("whisper3_serve", "whisper3", "serve", {"max_seq": MAX_SEQ}),
)
TRAIN = [t[0] for t in TASKS if t[2] == "train"]
SERVE = [t[0] for t in TASKS if t[2] == "serve"]


def ref_cfg(variant):
    arch, attention, _ = VARIANTS[variant]
    cfg = jtiny(jcb.get_config(arch)).replace(dtype="float32",
                                              param_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    if attention:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, **attention))
    return cfg


def port_cfg(variant):
    arch, attention, _ = VARIANTS[variant]
    moe = ref_cfg(variant).moe is not None
    return arch_cfg(arch, CF if moe else None, "float32", attention)


def tcfgs(optimizer):
    kw = dict(warmup_steps=2, decay_steps=20, seed=0, optimizer=optimizer)
    return JTrainConfig(**kw), TrainConfig(**kw)


def moments(tree) -> dict:
    """leaf path -> {"v_row", "v_col"} of Adafactor's factored leaves."""
    out: dict = {}
    for path, v in flat_numpy(tree).items():
        leaf, _, name = path.rpartition("/")
        if name in ("v_row", "v_col"):
            out.setdefault(leaf, {})[name] = v
    return out


def port_train(cfg, flat, batch, optimizer):
    """The port's one-device step: (params by path, metrics, grads as the
    step computed them, the factored moments by path)."""
    tcfg = tcfgs(optimizer)[1]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = state_of(cfg, tcfg, port_model(cfg, flat))
    seen = []

    def grads_plain(*args, **kw):
        res = real(*args, **kw)
        seen.append({k: g.clone() for k, g in res[2].items()})
        return res

    real, ts._grads_plain = ts._grads_plain, grads_plain
    try:
        state, metrics = make_train_step(cfg, tcfg)(state, batch)
    finally:
        ts._grads_plain = real
    grads = seen[0]
    params = {k: convert.stack_leaf(v).numpy() for k, v in
              convert.param_leaves(cfg, state["params"]).items()}
    mom = {k: {n: t.numpy() for n, t in v.items()}
           for k, v in state["opt"]["v"].items() if "v_row" in v} \
        if optimizer == "adafactor" else {}
    return params, {k: float(v) for k, v in metrics.items()}, \
        {k: g.numpy() for k, g in grads.items()}, mom


def port_serve(cfg, flat, serve, max_seq):
    model = port_model(cfg, flat)
    batch = {"tokens" if k == "prompts" else k: torch.from_numpy(v)
             for k, v in serve.items() if k != "steps"}
    steps = torch.from_numpy(serve["steps"])
    with torch.no_grad():
        pre, cache = models.prefill(cfg, model, batch)
        cache = widen(cfg, cache, steps.shape[0], max_seq)
        seen = []
        for t in range(steps.shape[1]):
            logits, cache = models.decode_step(cfg, model, cache,
                                               steps[:, t:t + 1])
            seen.append(logits.numpy())
    return pre.numpy(), np.stack(seen, 1)


def jax_widen(cfg, cache, max_seq):
    """The reference's prefill cache widened to ``max_seq`` slots."""
    def wide(t):
        pad = [(0, 0)] * t.ndim
        pad[2] = (0, max_seq - t.shape[2])
        return jnp.pad(t, pad)
    if cfg.is_encoder_decoder:
        return dict(cache, k=wide(cache["k"]), v=wide(cache["v"]))
    stack = tuple({n: wide(a) if n in ("k", "v") else a
                   for n, a in e.items()} for e in cache["stack"])
    return dict(cache, stack=stack)


def jax_serve(cfg, params, serve, max_seq):
    batch = {"tokens" if k == "prompts" else k: jnp.asarray(v)
             for k, v in serve.items() if k != "steps"}
    pre, cache = jax.jit(lambda p, b: jm.prefill(cfg, p, b))(params, batch)
    cache = jax_widen(cfg, cache, max_seq)
    step = jax.jit(lambda p, c, t: jm.decode_step(cfg, p, c, t))
    seen = []
    for t in range(serve["steps"].shape[1]):
        logits, cache = step(params, cache,
                             jnp.asarray(serve["steps"][:, t:t + 1]))
        seen.append(np.asarray(logits, np.float32))
    return np.asarray(pre, np.float32), np.stack(seen, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job_dir = str(tmp_path_factory.mktemp("mixers"))
    inputs, ref = {}, {}
    rng = np.random.default_rng(0)
    for variant, (arch, _, seed) in VARIANTS.items():
        cfg = ref_cfg(variant)
        optimizer = "adafactor" if variant == "qwen3" else "adamw"
        state0 = jinit_state(cfg, tcfgs(optimizer)[0],
                             jax.random.PRNGKey(seed))
        batch = {k: np.asarray(v, np.int64) for k, v in concrete_batch(
            cfg, BATCH, SEQ, jax.random.PRNGKey(seed + 100)).items()
                 if k != "frames"}
        serve = {"prompts": rng.integers(0, cfg.vocab_size,
                                         (BATCH, PROMPT)),
                 "steps": rng.integers(0, cfg.vocab_size, (BATCH, STEPS))}
        if cfg.is_encoder_decoder:
            frames = rng.standard_normal((BATCH, cfg.encoder_seq,
                                          cfg.d_model)).astype(np.float32)
            batch["frames"] = serve["frames"] = frames
        flat = flat_numpy(state0["params"])
        ref[variant] = {"cfg": cfg, "state0": state0, "batch": batch,
                        "serve": serve, "flat": flat,
                        "optimizer": optimizer}
        inputs.update({f"{variant}/{k}": v for k, v in flat.items()})
        inputs.update({f"{variant}/batch/{k}": v for k, v in batch.items()})
        inputs.update({f"{variant}/serve/{k}": v for k, v in serve.items()})
    np.savez(os.path.join(job_dir, "inputs.npz"), **inputs)
    tasks = {}
    for name, variant, kind, extra in TASKS:
        arch, attention, _ = VARIANTS[variant]
        part = "serve" if kind == "serve" else "batch"
        tasks[name] = dict(kind=kind, arch=arch, dtype="float32",
                           params=variant, attention=attention,
                           batch=f"{variant}/{part}", **extra)
        if ref[variant]["cfg"].moe is not None:
            tasks[name]["capacity_factor"] = CF
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump({"mesh": MESH, "tasks": tasks}, f)
    procs = start_ranks(job_dir, WORLD)
    got = {}
    try:
        # the references, while the ranks run
        for name, variant, kind, extra in TASKS:
            r, pcfg = ref[variant], port_cfg(variant)
            if kind == "train":
                jtcfg = tcfgs(r["optimizer"])[0]
                st, m = jax.jit(jmake_train_step(r["cfg"], jtcfg))(
                    r["state0"], {k: jnp.asarray(v)
                                  for k, v in r["batch"].items()})
                got[name] = {
                    "jax_params": flat_numpy(st["params"]),
                    "jax_loss": float(m["loss"]),
                    "jax_moments": moments(st["opt"]["v"])
                    if r["optimizer"] == "adafactor" else {},
                    "port": port_train(pcfg, r["flat"], r["batch"],
                                       r["optimizer"])}
            else:
                got[name] = {
                    "jax": jax_serve(r["cfg"], r["state0"]["params"],
                                     r["serve"], extra["max_seq"]),
                    "port": port_serve(pcfg, r["flat"], r["serve"],
                                       extra["max_seq"])}
    finally:
        wait_ranks(procs)
    out = np.load(os.path.join(job_dir, "out.npz"))
    return got, {k: out[k] for k in out.files}


@pytest.mark.parametrize("name", TRAIN)
def test_mixer_step_matches_jax_one_device(runs, name):
    ref, out = runs
    r = ref[name]
    assert abs(float(out[f"{name}/loss"]) - r["jax_loss"]) < 5e-2
    for k, want in r["jax_params"].items():
        np.testing.assert_allclose(out[f"{name}/p/{k}"], want, atol=3e-2,
                                   rtol=3e-2, err_msg=k)
    for k, m in r["jax_moments"].items():
        for part, want in m.items():
            np.testing.assert_allclose(out[f"{name}/{part}/{k}"], want,
                                       atol=3e-2, rtol=3e-2,
                                       err_msg=f"{k} {part}")


@pytest.mark.parametrize("name", TRAIN)
def test_mixer_grads_match_port_one_device(runs, name):
    ref, out = runs
    for k, want in ref[name]["port"][2].items():
        got = out[f"{name}/g/{k}"]
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= PORT_TOL * scale, k


@pytest.mark.parametrize("name", TRAIN)
def test_mixer_step_matches_port_one_device(runs, name):
    ref, out = runs
    params, metrics, _, mom = ref[name]["port"]
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
    for k, m in mom.items():
        for part, want in m.items():
            err, ok = within(out[f"{name}/{part}/{k}"], want, PORT_TOL)
            assert ok, (k, part, err)


def test_adafactor_moments_are_the_whole_leafs(runs):
    """Every factored leaf of the step has its moments, and each is the
    port's one-device moment within PORT_TOL of the leaf's own largest
    value: the means over split dims are the whole leaf's."""
    ref, out = runs
    mom = ref["qwen3_adafactor"]["port"][3]
    assert mom and set(mom) == set(ref["qwen3_adafactor"]["jax_moments"])
    for k, m in mom.items():
        for part, want in m.items():
            got = out[f"qwen3_adafactor/{part}/{k}"]
            assert got.shape == want.shape, (k, part)
            scale = float(np.abs(want).max())
            assert np.abs(got - want).max() <= PORT_TOL * scale, (k, part)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("name", SERVE)
def test_mixer_serve_matches_jax_one_device(runs, name, what):
    ref, out = runs
    want = ref[name]["jax"][what == "decode"]
    np.testing.assert_allclose(out[f"{name}/{what}"], want, atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("name", SERVE)
def test_mixer_serve_matches_port_one_device(runs, name, what):
    ref, out = runs
    want = ref[name]["port"][what == "decode"]
    floor = within(want, ref[name]["jax"][what == "decode"], 0.0)[0]
    err, ok = within(out[f"{name}/{what}"], want,
                     max(PORT_TOL, ROUNDING * floor))
    assert ok, (err, floor)
