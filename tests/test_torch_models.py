"""The port's dense decoder (``repro_torch.models``) against the JAX
package's (``repro.models``) on the CPU.

The JAX parameters are carried over with
``repro_torch.models.convert.params_from_numpy``; the same prompts and
tokens (numpy, seeded) go through both.  f32: prefill logits and cache,
then six decode steps (logits and the cache after them) within 1e-4.
bf16: within 5e-2 (the reference rounds its attention scores to bf16
before the softmax, the port's prefill kernel keeps them in f32).  One
prompt is 1024 tokens long, where the reference takes its q-chunked path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import base as jbase
from repro.configs import catalog as jcatalog
from repro.models.transformer import layer_schedules as j_layer_schedules
from repro_torch import models as tm
from repro_torch.configs import base as tbase
from repro_torch.configs import catalog as tcatalog
from repro_torch.models import convert
from repro_torch.models.transformer import layer_schedules

torch.set_num_threads(1)

DENSE = ["llama3.2-1b", "qwen2.5-14b", "stablelm-3b", "gemma3-4b"]
UNSUPPORTED = {"granite-moe-1b-a400m": "MoE", "qwen3-moe-235b-a22b": "MoE",
               "jamba-1.5-large-398b": "mamba", "rwkv6-1.6b": "rwkv6",
               "whisper-large-v3": "encoder-decoder"}


def _cfgs(arch, dtype):
    j = jcatalog.tiny(jbase.get_config(arch)).replace(dtype=dtype,
                                                       param_dtype=dtype)
    t = tcatalog.tiny(tbase.get_config(arch)).replace(dtype=dtype,
                                                       param_dtype=dtype)
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_catalogs_equal_field_for_field():
    assert tbase.list_archs() == jbase.list_archs()
    for arch in jbase.list_archs():
        j, t = jbase.get_config(arch), tbase.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert dataclasses.asdict(tcatalog.tiny(t)) == \
            dataclasses.asdict(jcatalog.tiny(j)), arch
        assert t.num_params() == j.num_params()
        assert t.active_params() == j.active_params()
    assert tbase.SHAPES.keys() == jbase.SHAPES.keys()
    with pytest.raises(ValueError, match="unknown arch"):
        tbase.get_config("nope")


@pytest.mark.parametrize("arch", DENSE + ["chameleon-34b"])
def test_param_count_and_schedules_equal(arch):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    assert tm.param_count(t) == jm.param_count(j)
    assert tm.param_count(tcatalog.tiny(t)) == jm.param_count(jcatalog.tiny(j))
    win, theta = j_layer_schedules(j)
    assert layer_schedules(t) == (np.asarray(win).reshape(-1).tolist(),
                                  np.asarray(theta).reshape(-1).tolist())


@pytest.mark.parametrize("arch,what", sorted(UNSUPPORTED.items()))
def test_unsupported_mixers_raise(arch, what):
    cfg = tcatalog.tiny(tbase.get_config(arch))
    for call in (lambda: tm.init_params(cfg, device="cpu"),
                 lambda: tm.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: tm.param_count(cfg)):
        with pytest.raises(NotImplementedError, match=what):
            call()


def _jax_decode_cache(cfg, cache1, max_seq):
    big = jm.init_cache(cfg, cache1["len"].shape[0], max_seq)
    S = cache1["stack"][0]["k"].shape[2]
    big["stack"] = jax.tree.map(
        lambda b, s: b.at[:, :, :S].set(s.astype(b.dtype)), big["stack"],
        cache1["stack"])
    big["len"] = cache1["len"]
    return big


def _close(got, want, tol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=what)


_jprefill = jax.jit(jm.prefill, static_argnums=0)
_jdecode = jax.jit(jm.decode_step, static_argnums=0)


def _run_both(arch, dtype, B, S, n_decode, tol, seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    params = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = _jprefill(jcfg, params, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill(tcfg, model, {"tokens": torch.from_numpy(toks)})
    _close(lt, lj, tol, f"{arch} prefill logits")
    ct_np = convert.cache_to_numpy(tcfg, ct)
    for name in ("k", "v"):
        _close(ct_np["stack"][0][name], cj["stack"][0][name], tol,
               f"{arch} prefill cache {name}")
    np.testing.assert_array_equal(ct_np["len"], np.asarray(cj["len"]))

    max_seq = S + n_decode + 3
    jc = _jax_decode_cache(jcfg, cj, max_seq)
    tc = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for step in range(n_decode):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, jc = _jdecode(jcfg, params, jc, jnp.asarray(tok))
        lt, tc = tm.decode_step(tcfg, model, tc, torch.from_numpy(tok))
        _close(lt, lj, tol, f"{arch} decode step {step} logits")
    tc_np = convert.cache_to_numpy(tcfg, tc)
    for name in ("k", "v"):
        _close(tc_np["stack"][0][name], jc["stack"][0][name], tol,
               f"{arch} decode cache {name}")
    np.testing.assert_array_equal(tc_np["len"], np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax_f32(arch):
    _run_both(arch, "float32", B=2, S=40, n_decode=6, tol=1e-4)


def test_long_prompt_matches_jax_qchunk_path_f32():
    """S = 1024 > 512 and a multiple of it: the reference attends through
    attend_qchunk, the port through the same K5 path as any prompt."""
    _run_both("llama3.2-1b", "float32", B=1, S=1024, n_decode=6, tol=1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-4b"])
def test_prefill_and_decode_match_jax_bf16(arch):
    _run_both(arch, "bfloat16", B=2, S=24, n_decode=6, tol=5e-2)


def test_init_params_draws_from_the_generator():
    cfg = tcatalog.tiny(tbase.get_config("qwen2.5-14b"))
    a = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    c = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["embed.tok"], pc["embed.tok"])
    assert pa["embed.tok"].dtype == torch.bfloat16
    assert "embed.head" in pa and "layers.0.attn.bq" in pa
    assert not any(p.requires_grad for p in a.parameters())
    # default generator: seeded 0 on the device
    d = tm.init_params(cfg, device="cpu")
    e = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(d.embed.tok, e.embed.tok)


def test_decode_cache_len_tracks_and_full_cache_writes_nothing():
    _, cfg = _cfgs("llama3.2-1b", "float32")
    model = tm.init_params(cfg, device="cpu")
    cache = tm.init_cache(cfg, 2, max_seq=3, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.int64)
    for _ in range(3):
        _, cache = tm.decode_step(cfg, model, cache, tok)
    assert cache["len"].tolist() == [3, 3]
    before = [c["k"].clone() for c in cache["layers"]]
    logits, cache = tm.decode_step(cfg, model, cache, tok)
    assert cache["len"].tolist() == [4, 4]
    assert all(torch.equal(b, c["k"]) for b, c in zip(before,
                                                       cache["layers"]))
    assert torch.isfinite(logits).all()
