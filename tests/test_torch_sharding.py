"""The port's sharding rules against the JAX package's, on stand-in meshes.

``repro_torch.sharding.specs`` / ``profiles`` resolve the reference's rule
tables; here they must give the reference's specs exactly, for every arch
of the catalog (tiny and full size, shapes only), on meshes (2, 2),
(2, 2, 2), (16, 16) and (2, 16, 16), under the train and the decode
rules.  Neither side needs devices: a stand-in with ``axis_names``,
``shape`` (a dict) and ``devices`` serves both.  Then the port's blocks:
the blocks of every coordinate (``shard_leaf``) assemble the global tensor
again (``block_slices``), and the cache's k / v spec in the port's layout
is the reference's permuted.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import base as jcb
from repro.configs.catalog import tiny as jtiny
from repro.sharding import profiles as jprofiles
from repro.sharding import specs as jspecs
from repro_torch.configs import base as cbase
from repro_torch.configs.catalog import tiny
from repro_torch.sharding import layout, profiles, specs

ARCHS = jcb.list_archs()
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STEPS = ("train", "decode")


def stand_in(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                           devices=np.empty(shape))


def cfgs(arch):
    """(reference config, port config) at tiny and at full size."""
    for small in (True, False):
        j, t = jcb.get_config(arch), cbase.get_config(arch)
        yield (jtiny(j), tiny(t)) if small else (j, t)


def ref_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jspecs._path_str(p): v for p, v in leaves}


def ref_param_shapes(cfg):
    return jax.eval_shape(lambda k: jm.init_params(cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def ref_cache_shapes(cfg):
    return jax.eval_shape(lambda: jm.init_cache(cfg, 8, 64))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_equal(arch, mesh_name):
    mesh = stand_in(mesh_name)
    for j, t in cfgs(arch):
        for step in STEPS:
            assert profiles.rules_for(t, mesh, step).__dict__ == \
                jprofiles.rules_for(j, mesh, step).__dict__, (step, j.name)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal(arch, mesh_name):
    mesh = stand_in(mesh_name)
    for j, t in cfgs(arch):
        shapes = ref_param_shapes(j)
        port_shapes = layout.leaf_shapes(t)
        want_shapes = {k: tuple(v.shape) for k, v in ref_flat(shapes).items()}
        assert port_shapes == want_shapes, j.name
        for step in STEPS:
            rules = profiles.rules_for(t, mesh, step)
            want = ref_flat(jspecs.param_specs(
                shapes, mesh, jprofiles.rules_for(j, mesh, step)))
            got = specs.param_specs(port_shapes, mesh, rules)
            assert got == {k: tuple(v) for k, v in want.items()}, \
                (step, j.name)
            assert layout.model_specs(t, mesh, rules) == got


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal(arch, mesh_name):
    mesh = stand_in(mesh_name)
    for j, t in cfgs(arch):
        shapes = {k: tuple(v.shape)
                  for k, v in ref_flat(ref_cache_shapes(j)).items()}
        for step in STEPS:
            jr = jprofiles.rules_for(j, mesh, step)
            want = ref_flat(jspecs.cache_specs(ref_cache_shapes(j), mesh, jr))
            rules = profiles.rules_for(t, mesh, step)
            got = specs.cache_specs(shapes, mesh, rules)
            assert got == {k: tuple(v) for k, v in want.items()}, \
                (step, j.name)
            if t.attention is not None and not t.is_encoder_decoder \
                    and "stack/0/k" in got:
                k = got["stack/0/k"]
                with specs.use_mesh(mesh, rules):
                    assert layout.kv_spec(t, 8, 64) == (k[1], k[3], k[2],
                                                        k[4])


LOGICAL = [((8, 64), ("batch", None)),
           ((8, 64, 1024), ("batch", "seq", "dmodel")),
           ((4, 2048, 16, 64), ("batch", "kvseq", "kvheads", None)),
           ((1024, 16, 64), ("fsdp", "heads", None)),
           ((49155, 1024), ("vocab", "fsdp")),
           ((32, 1024, 512), ("expert", "fsdp", "ffn")),
           ((3, 5), ("heads", "ffn")),
           ((16, 16), ("heads", "kvheads")),
           ((2, 8), ("batch", "batch"))]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_logical_to_spec_equal(mesh_name):
    mesh = stand_in(mesh_name)
    rules = [specs.MeshRules(), specs.MeshRules(fsdp=("pod", "data")),
             specs.MeshRules(batch="data", heads=("data", "model"))]
    for r in rules:
        jr = jspecs.MeshRules(**r.__dict__)
        for shape, logical in LOGICAL:
            assert specs.logical_to_spec(shape, logical, mesh, r) == tuple(
                jspecs.logical_to_spec(shape, logical, mesh, jr))


@pytest.mark.parametrize("mesh_name", MESHES)
def test_strip_and_restrict_equal(mesh_name):
    mesh = stand_in(mesh_name)
    for kw in ({}, {"fsdp": ("pod", "data")}, {"seqcarry": "model"},
               {"batch": "pod", "kvseq": ("data", "model")}):
        r, jr = specs.MeshRules(**kw), jspecs.MeshRules(**kw)
        assert r.restrict(mesh).__dict__ == jr.restrict(mesh).__dict__
        for ax in ("pod", "data", "model"):
            assert r.strip(ax).__dict__ == jr.strip(ax).__dict__


def test_parse_rule_overrides_equal():
    pairs = ["seqcarry=model", "fsdp=pod,data", "kvseq=", "batch=data,",
             "heads=model"]
    assert profiles.parse_rule_overrides(pairs) == \
        jprofiles.parse_rule_overrides(pairs)


def test_use_mesh_rejects_unknown_axis():
    mesh = stand_in("2x2")
    with pytest.raises(ValueError, match="unknown mesh axis 'pod'"):
        with specs.use_mesh(mesh, specs.MeshRules(batch=("pod", "data"))):
            pass
    assert not specs.active()
    with specs.use_mesh(mesh, specs.MeshRules(batch="data")):
        assert specs.active() and specs.current_mesh() is mesh
    assert specs.current_mesh() is None


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_blocks_assemble_the_leaf(arch, mesh_name):
    """Every coordinate's block (shard_leaf), written back at its slices,
    gives the global tensor: the inverse that gather_leaf computes with
    collectives."""
    mesh = stand_in(mesh_name)
    cfg = tiny(cbase.get_config(arch))
    gen = torch.Generator().manual_seed(0)
    axes = mesh.axis_names
    coords = [dict(zip(axes, c)) for c in np.ndindex(*mesh.devices.shape)]
    shapes = layout.leaf_shapes(cfg)
    for step in STEPS:
        rules = profiles.rules_for(cfg, mesh, step)
        for path, spec in layout.model_specs(cfg, mesh, rules).items():
            shape = shapes[path]
            t = torch.randn(shape, generator=gen)
            back = torch.full(shape, float("nan"))
            n = int(np.prod([mesh.shape[a] for e in spec
                             for a in specs.entry_axes(e)]))
            seen = set()
            for c in coords:
                sl = specs.block_slices(shape, spec, mesh, c)
                back[sl] = specs.shard_leaf(t, spec, mesh, c)
                seen.add(tuple((s.start, s.stop) for s in sl))
            assert len(seen) == n, (path, spec)
            assert torch.equal(back, t), (path, spec)


def test_mesh_refuses_what_it_does_not_carry():
    """What the mesh path does not carry raises before any collective: an
    rwkv6 time-mix whose heads would straddle two ranks, a mamba mixer
    whose expanded channels do not split evenly, a weight split over FSDP
    and tensor-parallel axes on one dim, and a spec that splits a stacked
    leaf's period dim."""
    from repro_torch import models
    from repro_torch.models import mamba, rwkv6
    from repro_torch.sharding import comm
    wide = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 1, "model": 8},
                           devices=np.empty((1, 8)))
    rules = specs.MeshRules(batch="data")
    for arch, mixer, part in (("rwkv6-1.6b", rwkv6.rwkv6_forward, "rwkv"),
                              ("jamba-1.5-large-398b", mamba.mamba_forward,
                               "mamba")):
        cfg = tiny(cbase.get_config(arch)).replace(dtype="float32",
                                                   param_dtype="float32")
        model = models.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        layer = next(l for l in model.layers if hasattr(l, part))
        params = getattr(layer, part)
        name = "w_r" if part == "rwkv" else "in_proj"
        layout.tagged(params[name], (None, "model"))
        mesh = wide if part == "rwkv" else SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 1, "model": 256},
            devices=np.empty((1, 256)))
        mcfg = cfg.rwkv6 if part == "rwkv" else cfg.mamba
        with specs.use_mesh(mesh, rules):
            with pytest.raises(NotImplementedError, match="not split over"):
                mixer(mcfg, params, torch.zeros((2, 4, cfg.d_model)))
    w = layout.tagged(torch.zeros((8, 4)), (("data", "model"), None))
    with specs.use_mesh(wide, specs.MeshRules(batch="data",
                                              fsdp=("data",))):
        with pytest.raises(NotImplementedError, match="FSDP and"):
            comm.weight(w)
    with pytest.raises(NotImplementedError, match="stacked period dim"):
        layout._per_layer("stack/0/mlp/w_in", ("data", None, "model"), True)


def test_microbatches_keep_the_batch_split():
    """Under a mesh a microbatch must stay divisible by the batch-splitting
    degree, the reference's check; each rank takes its rows of each."""
    from repro_torch.sharding import comm
    from repro_torch.train import train_step as ts
    mesh = stand_in("2x2")
    mesh.coords = {"data": 1, "model": 0}
    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3)}
    with specs.use_mesh(mesh, specs.MeshRules(batch="data")), \
            comm.batch(("data",)):
        with pytest.raises(ValueError, match="batch-sharding degree 2"):
            ts._split_microbatches(batch, 8)
        micro = ts._split_microbatches(batch, 2)
    assert [m["tokens"][:, 0].tolist() for m in micro] == [[2, 3], [6, 7]]
