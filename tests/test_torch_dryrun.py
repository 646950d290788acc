"""The port's dry-run (``repro_torch.launch.dryrun``) and its cost analysis
(``launch.costanalysis``): ROADMAP.md C18.

No test in ``tests/`` covers the reference's dry-run, so this file states
the contract:

(a) **Argument bytes.**  At the production meshes (a ``fake`` world of 256
    or 512 ranks, rank 0), the rank's ``argument_bytes`` equal, exactly,
    the bytes that the JAX package's ``param_specs`` / ``cache_specs`` give
    rank 0 of the reference's state or parameters and cache, plus its rows
    of the batch (stand-in meshes as in ``test_torch_sharding.py``).
    Adafactor's factored moments take the reference's spec of their leaf
    without the dim each averages over (the reference's ``PARAM_RULES``
    match no ``.../v_row`` path: its dry-run holds them replicated).
(b) **Collectives.**  On tiny llama and granite-moe at (pod 2, data 2,
    model 2), the collectives the counter logs under the ``fake`` backend
    on meta tensors equal, kind by kind, group by group and byte by byte,
    those that the same step logs on 8 real gloo ranks
    (``torch_mesh_worker.py``'s ``cost`` task).
(c) **FLOPs.**  On tiny dense cells on one device (prefill and train,
    remat none and full), the counter's FLOPs against
    ``repro.launch.hloanalysis.analyze_hlo`` of the JAX package's compiled
    step: within FLOP_BAND as they stand, and equal exactly once the named
    gap is taken out of both — the port's attention (K5's whole tiles over
    the causal / window blocks its launcher visits, and its backward's
    five products over each tile's keys up to the tile's last row) and
    K8's own 4 FLOPs a value, against the reference's plain full-square
    attention dots (forward 4·S²·hd a head, backward twice that, once more
    under remat) — and against ``model_flops`` within MODEL_BAND.
(d) **No failures.**  At tiny size on a test mesh (each arch with its
    full size's train config: Adafactor for the two largest) every cell of
    ARCHS x SHAPES is ``ok``, with its roofline and memory fields, or
    ``skipped`` exactly where ``shape_applicable`` says so; none fails,
    the mamba, rwkv6, encoder-decoder and Adafactor cells included.  (That
    every production cell is ``ok`` or skipped is what ``--all`` shows;
    its sweep takes minutes.)

Besides, the kernel wrappers' meta branches: reached only by meta tensors
under a counter, launching nothing, outputs of the kernel's shapes and
dtypes, FLOPs and bytes from their ``meta_cost``; ``flash_attention.tiles``
against a brute-force count of the tiles with an unmasked pair; the CLI.
Every fake world is torn down by ``dryrun.fake_world``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import models as jm
from repro.configs import base as jcb
from repro.configs import inputs as jinputs
from repro.configs.catalog import tiny as jtiny
from repro.launch.hloanalysis import analyze_hlo
from repro.sharding import profiles as jprofiles
from repro.sharding import specs as jspecs
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro.train.train_step import init_state as jinit_state
from repro_torch.configs import base as cbase
from repro_torch.configs.catalog import tiny
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import lm_lib
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import rwkv6_scan as RW
from repro_torch.launch import costanalysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train import TrainConfig
from torch_mesh_worker import start_ranks, wait_ranks

#: (c): the counter's FLOPs over analyze_hlo's, as they stand.
FLOP_BAND = (0.7, 1.1)
#: (c): the counter's FLOPs over model_flops (6 N D / 2 N D: the
#: parameters' products only; the counter adds attention, which at the
#: tiny widths (d 64) outweighs them at 640 positions, and under remat the
#: recomputed forward; a prefill's head runs on the last position only).
MODEL_BAND = (0.9, 3.5)


def ref_tcfg(cfg) -> JTrainConfig:
    """The reference dry-run's ``default_tcfg`` (its module is not
    imported: it sets XLA_FLAGS for 512 devices on import), from the
    port's, whose fields are the reference's."""
    return JTrainConfig(**dataclasses.asdict(dryrun.default_tcfg(cfg)))


def production(multi_pod: bool):
    return (512 if multi_pod else 256,
            lambda: dryrun.make_production_mesh(multi_pod=multi_pod))


# --------------------------------------------------------------------------
# (a) argument bytes against the reference's specs
# --------------------------------------------------------------------------
def stand_in(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                           devices=np.empty(shape))


def rank_bytes(tree, specs, mesh) -> int:
    """Bytes of rank 0's blocks of ``tree`` under ``specs``."""
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(specs)
    total = 0
    for leaf, spec in zip(leaves, specs):
        n = leaf.size * leaf.dtype.itemsize
        for entry in spec:
            for ax in () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry):
                assert n % mesh.shape[ax] == 0
                n //= mesh.shape[ax]
        total += n
    return total


def batch_bytes(batch, mesh, rules) -> int:
    specs = jax.tree.map(lambda x: jspecs.logical_to_spec(
        x.shape, ("batch",) + (None,) * (x.ndim - 1), mesh, rules), batch)
    return rank_bytes(batch, specs, mesh)


def ref_flat(tree, is_leaf=None) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jspecs._path_str(p): v for p, v in leaves}


def moment_specs(state, specs) -> dict:
    """The reference's specs of a train state by path, Adafactor's factored
    moments (``opt/v/<leaf>/v_row`` / ``v_col``) given their leaf's spec
    without its last / next-to-last entry."""
    shapes = ref_flat(state)
    specs = ref_flat(specs, lambda x: isinstance(x,
                                                 jax.sharding.PartitionSpec))
    out = {}
    for path in shapes:
        leaf, _, name = path.rpartition("/")
        if path.startswith("opt/v/") and name in ("v_row", "v_col"):
            spec = tuple(specs["params/" + leaf[len("opt/v/"):]])
            spec = spec[:-1] if name == "v_row" else spec[:-2] + spec[-1:]
            out[path] = jax.sharding.PartitionSpec(*spec)
        else:
            out[path] = specs[path]
    return out


def ref_argument_bytes(arch, shape_name, multi_pod) -> int:
    cfg, shape = jcb.get_config(arch), jcb.SHAPES[shape_name]
    mesh = stand_in(multi_pod)
    rules = jprofiles.rules_for(cfg, mesh, shape.step)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    if shape.step == "train":
        tcfg = ref_tcfg(cbase.get_config(cfg.name))
        state = jax.eval_shape(lambda k: jinit_state(cfg, tcfg, k), key)
        specs = moment_specs(state, jspecs.param_specs(state, mesh, rules))
        flat = ref_flat(state)
        return (rank_bytes([flat[k] for k in specs], list(specs.values()),
                           mesh)
                + batch_bytes(jinputs.train_inputs(cfg, shape), mesh, rules))
    params = jax.eval_shape(lambda k: jm.init_params(cfg, k), key)
    n = rank_bytes(params, jspecs.param_specs(params, mesh, rules), mesh)
    if shape.step == "prefill":
        return n + batch_bytes(jinputs.prefill_inputs(cfg, shape), mesh,
                               rules)
    cache, tokens = jinputs.decode_inputs(cfg, shape)
    return (n + rank_bytes(cache, jspecs.cache_specs(cache, mesh, rules),
                           mesh)
            + batch_bytes({"t": tokens}, mesh, rules))


#: The state and the batch's rows do not depend on the microbatching: one
#: microbatch keeps the 235 B train cell's step on meta to a few seconds
#: (its 8 take minutes).
ONE_MICROBATCH = {"qwen3-moe-235b-a22b": {"grad_accum": 1}}


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("llama3.2-1b", "decode_32k", False),
    ("granite-moe-1b-a400m", "train_4k", True),
    ("gemma3-4b", "decode_32k", True),
    ("rwkv6-1.6b", "decode_32k", False),
    ("jamba-1.5-large-398b", "prefill_32k", True),
    ("whisper-large-v3", "decode_32k", False),
    ("qwen3-moe-235b-a22b", "train_4k", True),
])
def test_argument_bytes_equal_the_reference_specs(arch, shape_name,
                                                  multi_pod):
    rec = dryrun.cell_record(cbase.get_config(arch), cbase.SHAPES[shape_name],
                             *production(multi_pod),
                             tcfg_kw=ONE_MICROBATCH.get(arch))
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["rank"] == 0
    assert rec["memory"]["argument_bytes"] == \
        ref_argument_bytes(arch, shape_name, multi_pod)
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# (b) collectives: fake backend on meta == 8 gloo ranks on the CPU
# --------------------------------------------------------------------------
COST_TASKS = {
    "llama_train": ("llama3.2-1b", "train", 32, 8),
    "granite_train": ("granite-moe-1b-a400m", "train", 32, 8),
    "llama_prefill": ("llama3.2-1b", "prefill", 16, 8),
    "llama_decode": ("llama3.2-1b", "decode", 16, 8),
    "granite_decode": ("granite-moe-1b-a400m", "decode", 16, 8),
}
MESH = {"pod": 2, "data": 2, "model": 2}


@pytest.fixture(scope="module")
def gloo_logs(tmp_path_factory):
    job_dir = str(tmp_path_factory.mktemp("cost"))
    tasks = {name: {"kind": "cost", "arch": arch, "step": step, "seq": seq,
                    "batch": batch}
             for name, (arch, step, seq, batch) in COST_TASKS.items()}
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump({"mesh": MESH, "tasks": tasks}, f)
    np.savez(os.path.join(job_dir, "inputs.npz"))
    wait_ranks(start_ranks(job_dir, 8))
    out = np.load(os.path.join(job_dir, "out.npz"))
    return {name: json.loads(str(out[f"{name}/log"])) for name in tasks}


@pytest.mark.parametrize("name", COST_TASKS)
def test_collectives_equal_gloo(name, gloo_logs):
    arch, step, seq, batch = COST_TASKS[name]
    rec = dryrun.cell_record(
        tiny(cbase.get_config(arch)), cbase.ShapeConfig(name, seq, batch,
                                                        step),
        8, lambda: make_test_mesh(**MESH), tcfg=TrainConfig())
    assert rec["status"] == "ok", rec.get("trace")
    want = gloo_logs[name]
    assert want["collective_count"], "the step issued no collective"
    for key in ("collective_operand_bytes", "collective_wire_bytes",
                "collective_count"):
        assert rec["roofline"][key] == want[key], key


# --------------------------------------------------------------------------
# (c) FLOPs against analyze_hlo and model_flops
# --------------------------------------------------------------------------
def ref_flops(jcfg, step, S, B) -> float:
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    shape = jcb.ShapeConfig("c", S, B, step)
    if step == "train":
        tcfg = JTrainConfig()
        state = jax.eval_shape(lambda k: jinit_state(jcfg, tcfg, k), key)
        lowered = jax.jit(jmake_train_step(jcfg, tcfg)).lower(
            state, jinputs.train_inputs(jcfg, shape))
    else:
        params = jax.eval_shape(lambda k: jm.init_params(jcfg, k), key)
        lowered = jax.jit(lambda p, b: jm.prefill(jcfg, p, b)).lower(
            params, jinputs.prefill_inputs(jcfg, shape))
    return analyze_hlo(lowered.compile().as_text()).flops


def flash_backward_flops(S, BH, hd, tile=FA.BWD_TILE) -> float:
    """``flash_attention_backward``'s products at Sq = Sk = S, causal:
    scores, dP, dq, dk, dv, 2·hd a pair each, over each tile's rows and
    its keys up to the tile's last row."""
    total = 0
    for i0 in range(0, S, tile):
        i1 = min(S, i0 + tile)
        total += 10 * hd * BH * (i1 - i0) * min(S, i1)
    return float(total)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-4b",
                                  "stablelm-3b"])
@pytest.mark.parametrize("step,S,B,remat", [
    ("prefill", 128, 2, "none"), ("train", 128, 2, "none"),
    ("train", 640, 1, "full")])
def test_flops_against_analyze_hlo(arch, step, S, B, remat):
    cfg = tiny(cbase.get_config(arch)).replace(remat=remat)
    jcfg = jtiny(jcb.get_config(arch)).replace(remat=remat)
    shape = cbase.ShapeConfig("c", S, B, step)
    got = dryrun.measure(*dryrun.build_cell(cfg, shape, None, None,
                                            TrainConfig()))
    cost, want = got["cost"], ref_flops(jcfg, step, S, B)
    assert FLOP_BAND[0] <= cost.flops / want <= FLOP_BAND[1]
    mf = dryrun.model_flops(cfg, shape)
    assert MODEL_BAND[0] <= cost.flops / mf <= MODEL_BAND[1]
    # the named gap: each side's attention and K8's own FLOPs
    a, L = cfg.attention, cfg.num_layers
    BH = B * a.num_heads
    ref_fwd = 4.0 * BH * S * S * a.head_dim * L
    ref_attn = ref_fwd if step == "prefill" else \
        ref_fwd * (3 + (remat != "none"))
    port_attn = cost.kernels["flash_attention"]["flops"]
    if step == "train":
        port_attn += flash_backward_flops(S, BH, a.head_dim) * L
    assert cost.kernels["flash_attention"]["launches"] == \
        L * (1 + (step == "train" and remat != "none"))
    assert cost.flops - port_attn - cost.kernels["rmsnorm"]["flops"] == \
        want - ref_attn


# --------------------------------------------------------------------------
# (d) every cell ok or skipped by shape_applicable
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_cells_ok_skipped_or_a13(arch):
    """Every cell ok or skipped; no cell fails (the name is kept from when
    the mamba, rwkv6, encoder-decoder and Adafactor cells raised)."""
    full = cbase.get_config(arch)
    cfg, tcfg = tiny(full), dryrun.default_tcfg(full)
    for shape_name in dryrun.SHAPES:
        shape = cbase.SHAPES[shape_name]
        rec = dryrun.cell_record(cfg, shape, 8,
                                 lambda: make_test_mesh(**MESH), tcfg=tcfg)
        applicable = cbase.shape_applicable(cfg, shape)[0]
        assert rec["status"] == ("ok" if applicable else "skipped"), \
            rec.get("trace", rec)
        if rec["status"] == "ok":
            r = rec["roofline"]
            assert r["flops"] > 0 and r["traffic_bytes"] > 0
            assert r["part"] == ca.PART
            m = rec["memory"]
            assert m["peak_bytes_per_device"] == (
                m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
                - m["alias_bytes"])
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# The kernels' meta branches
# --------------------------------------------------------------------------
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _no_launch(*args, **kw):
    raise AssertionError("the meta branch launched a kernel")


KERNEL_CALLS = {
    "flash_attention": lambda: (FA.flash_attention(
        _meta(8, 200, 64, dtype=torch.bfloat16),
        _meta(2, 200, 64, dtype=torch.bfloat16),
        _meta(2, 200, 64, dtype=torch.bfloat16), window=70),
        [((8, 200, 64), torch.bfloat16)],
        FA.meta_cost(_meta(8, 200, 64, dtype=torch.bfloat16),
                     _meta(2, 200, 64, dtype=torch.bfloat16), True, 70)),
    "rmsnorm": lambda: (RN.rmsnorm(_meta(3, 5, 64, dtype=torch.bfloat16),
                                   _meta(64, dtype=torch.bfloat16)),
                        [((3, 5, 64), torch.bfloat16)],
                        (4.0 * 960, 2 * (2 * 960 + 64))),
    "rwkv6_scan": lambda: (RW.rwkv6_scan(*[_meta(4, 9, 64)] * 4,
                                         _meta(4, 64), _meta(4, 64, 64)),
                           [((4, 9, 64), torch.float32),
                            ((4, 64, 64), torch.float32)],
                           (4 * 9 * (5 * 64 * 64 + 5 * 64),
                            4 * (5 * 4 * 9 * 64 + 4 * 64 + 2 * 4 * 64 * 64))),
    "mamba_scan": lambda: (MS.mamba_scan(
        _meta(2, 7, 48), _meta(2, 7, 48), _meta(2, 7, 16), _meta(2, 7, 16),
        _meta(48, 16)), [((2, 7, 48), torch.float32),
                         ((2, 48, 16), torch.float32)],
        (6.0 * 2 * 7 * 48 * 16,
         4 * (2 * 2 * 7 * 48 + 2 * 2 * 7 * 16 + 48 * 16 + 2 * 7 * 48
              + 2 * 48 * 16))),
}


@pytest.mark.parametrize("name", KERNEL_CALLS)
def test_meta_branch_counts_and_launches_nothing(name, monkeypatch):
    monkeypatch.setattr(lm_lib, "launch", _no_launch)
    launches = (FA.flash_attention.launches, RN.rmsnorm.launches,
                RW.rwkv6_scan.launches, MS.mamba_scan.launches)
    with ca.CostCounter() as counter:
        out, shapes, (flops, n_bytes) = KERNEL_CALLS[name]()
    outs = out if isinstance(out, tuple) else (out,)
    assert [(tuple(t.shape), t.dtype) for t in outs] == shapes
    assert all(t.device.type == "meta" for t in outs)
    assert counter.cost.kernels == {name: {"launches": 1, "flops": flops,
                                           "bytes": n_bytes}}
    assert counter.cost.n_ops == 1
    assert (FA.flash_attention.launches, RN.rmsnorm.launches,
            RW.rwkv6_scan.launches, MS.mamba_scan.launches) == launches


def _scan_inputs(name):
    if name == "rwkv6_scan":
        return [_meta(4, 9, 64) for _ in range(4)] + [_meta(4, 64)]
    return [_meta(2, 7, 48), _meta(2, 7, 48), _meta(2, 7, 16),
            _meta(2, 7, 16), _meta(48, 16)]


@pytest.mark.parametrize("name", ["rwkv6_scan", "mamba_scan"])
def test_meta_scan_backward_counts_by_formula(name, monkeypatch):
    """K6's and K7's backward on meta under a counter: the inputs'
    gradients' shapes, nothing launched or dispatched step by step, the
    plain backward counted as BACKWARD_WORK x the forward's FLOPs and
    twice its bytes."""
    from repro_torch.kernels import grad as KG
    monkeypatch.setattr(lm_lib, "launch", _no_launch)
    mod = RW if name == "rwkv6_scan" else MS
    ins = [t.requires_grad_() for t in _scan_inputs(name)]
    flops, n_bytes = mod.meta_cost(*ins, *([None] * (name == "rwkv6_scan")))
    with ca.CostCounter() as counter:
        y, s = getattr(mod, name)(*ins)
        grads = torch.autograd.grad(y.sum() + s.sum(), ins)
    assert [(g.shape, g.device.type) for g in grads] == \
        [(t.shape, "meta") for t in ins]
    assert counter.cost.kernels[f"{name}_grad"] == {
        "launches": 1, "flops": KG.BACKWARD_WORK * flops,
        "bytes": 2.0 * n_bytes}
    # the forward, two sums and their backward: no step of a scan
    assert counter.cost.n_ops < 20


def test_meta_without_a_counter_raises():
    with pytest.raises(ValueError, match="meta ones under a cost counter"):
        RN.rmsnorm(_meta(4, 64), _meta(64))


@pytest.mark.parametrize("tc", [True, False])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (256, 256, True, 0), (200, 320, True, 0), (320, 320, False, 0),
    (384, 384, True, 100), (333, 384, True, 64), (128, 256, False, 70)])
def test_flash_tiles_are_the_tiles_with_an_unmasked_pair(tc, Sq, Sk, causal,
                                                         window):
    """At each head dim of the path, for the tile :func:`FA.tile` gives
    (``test_torch_flash_split.py`` holds it to ``Tiles<HD>::BM`` in
    ``flash_attention_sm90.cu``)."""
    for hd in FA.TC_HEAD_DIMS if tc else (64,):
        BM, BN = FA.tile(tc, hd)
        q = np.arange(-(-Sq // BM) * BM)[:, None]
        k = np.arange(Sk)[None, :]
        ok = np.ones((q.size, Sk), bool)
        if causal:
            ok &= q >= k
        if window:
            ok &= (q - k) < window
        want = sum(bool(ok[q0:q0 + BM, k0:k0 + BN].any())
                   for q0 in range(0, q.size, BM) for k0 in range(0, Sk, BN))
        assert FA.tiles(Sq, Sk, causal, window, tc, hd) == want


def test_collective_wire_bytes_follow_the_ring():
    assert ca.wire_bytes("all-reduce", 160, 160, 16) == 2 * 160 * 15 / 16
    assert ca.wire_bytes("all-gather", 10, 160, 16) == 160 * 15 / 16
    assert ca.wire_bytes("reduce-scatter", 160, 10, 16) == 160 * 15 / 16
    assert ca.wire_bytes("all-to-all", 160, 160, 2) == 80


def test_cli_writes_one_record_per_cell(tmp_path):
    out = str(tmp_path / "dr")
    recs = dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", out, "--tag", "t"])
    path = os.path.join(out, "pod1", "llama3.2-1b__decode_32k__t.json")
    with open(path) as f:
        rec = json.load(f)
    assert rec["status"] == recs[0]["status"] == "ok"
    assert rec["roofline"]["part"] == ca.PART
    assert rec["kernels"]["rmsnorm"]["launches"] == \
        2 * cbase.get_config("llama3.2-1b").num_layers + 1
    recs = dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                        "--out", out])
    assert recs[0]["status"] == "ok", recs[0].get("trace")
    assert recs[0]["kernels"]["rwkv6_scan"]["launches"] == \
        cbase.get_config("rwkv6-1.6b").num_layers
    # a cell that fails (int8 compression needs a pod axis) exits 1
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                     "--compress", "int8", "--out", out])
    assert e.value.code == 1
