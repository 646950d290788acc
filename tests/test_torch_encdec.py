"""The port's encoder-decoder stack (``repro_torch.models.encdec``,
whisper) against the JAX package's (``repro.models.encdec``) on the CPU.

JAX's parameters are carried over with
``repro_torch.models.convert.params_from_numpy``; the same frames and
tokens (numpy, seeded) go through both.  tiny(whisper) has 2 encoder and 2
decoder layers of width 64 over 16 frames.

* f32: ``encode``, ``project_enc_kv_stack``, the prefill logits and cache
  (self k / v, ``enc_kv``, ``len``), and six ``decode_step``s after a
  reference-built cache (logits, then the cache), within 1e-4 (atol and
  rtol).  bf16: each tensor within 5e-2 of its own largest magnitude (as
  ROADMAP C11 holds the bf16 layers).
* ``loss_fn`` within 1e-5 relative and every gradient leaf within 1e-4 *
  max(1, max|JAX's|) of ``jax.value_and_grad``; three AdamW steps of the
  train step within 2e-5 * max(1, max|JAX's|) of the reference's
  ``train_step``, with ``test_torch_train_step.py``'s rule for elements
  whose gradient is near zero.
* ``param_count`` of whisper-large-v3 and tiny(whisper) equal to the
  reference's (1 535 342 080 at full size); the cache round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import train as jt
from repro.configs import base as jbase
from repro.configs import catalog as jcatalog
from repro.models import encdec as jed
from repro.train import train_step as jts
from repro_torch import models as tm
from repro_torch import train as tt
from repro_torch.configs import base as tbase
from repro_torch.configs import catalog as tcatalog
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import encdec as ted
from test_torch_train import _flat, _port_grads

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
F32_TOL = 1e-4
BF16_TOL = 5e-2


def _cfgs(dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jcatalog.tiny(jbase.get_config(ARCH)).replace(**kw),
            tcatalog.tiny(tbase.get_config(ARCH)).replace(**kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max())
        lim = BF16_TOL * float(np.abs(want).max())
        assert err <= lim, f"{what}: max|d| {err} over {lim}"


def _setup(dtype, seed=0):
    jcfg, tcfg = _cfgs(dtype)
    params = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, tcfg, params, model


def _frames(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "frames": _frames(cfg, B, seed)}


# --------------------------------------------------------------------------
# Counts and layouts
# --------------------------------------------------------------------------
def test_param_count_matches_the_reference():
    j, t = jbase.get_config(ARCH), tbase.get_config(ARCH)
    assert tm.param_count(t) == jm.param_count(j) == 1_535_342_080
    assert tm.param_count(tcatalog.tiny(t)) == \
        jm.param_count(jcatalog.tiny(j))
    assert tm.active_param_count(t) == jm.active_param_count(j) == \
        tm.param_count(t)
    # the closed form counts whisper's ungated MLP as a gated one
    assert t.num_params() == 1_954_031_360


def test_param_leaves_are_the_reference_tree():
    jcfg, tcfg, params, model = _setup("float32")
    want = {k: v.shape for k, v in _flat(params).items()}
    got = {k: tuple(convert.stack_leaf(v).shape)
           for k, v in convert.param_leaves(tcfg, model).items()}
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_round_trip(dtype):
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(1)
    jc = jax.tree.map(np.asarray, jm.init_cache(jcfg, 2, 9))
    jc = jax.tree.map(
        lambda a: (rng.integers(0, 9, a.shape).astype(a.dtype)
                   if a.dtype == np.int32 else
                   rng.standard_normal(a.shape).astype(np.float32)
                   .astype(a.dtype)), jc)
    back = convert.cache_to_numpy(tcfg, convert.cache_from_numpy(
        tcfg, jc, "cpu"))
    assert back.keys() == jc.keys()
    for name in ("k", "v", "len"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(jc[name], back[name].dtype))
    for got, want in zip(back["enc_kv"], jc["enc_kv"]):
        np.testing.assert_array_equal(got, np.asarray(want, got.dtype))
    tc = tm.init_cache(tcfg, 2, 9, device="cpu")
    assert [tuple(a.shape) for a in (tc["layers"][0]["k"],
                                     tc["layers"][0]["enc_k"])] == \
        [(2, 4, 9, 16), (2, 4, 16, 16)]


def test_sinusoidal_matches_the_reference():
    pos = np.arange(40, dtype=np.int32)
    _close(ted.sinusoidal(torch.from_numpy(pos), 64),
           jed.sinusoidal(jnp.asarray(pos), 64), "float32", "sinusoidal")


# --------------------------------------------------------------------------
# Serving: encode, prefill, decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_enc_kv_match_jax(dtype):
    jcfg, tcfg, params, model = _setup(dtype)
    frames = _frames(jcfg, 2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    je = jax.jit(lambda p, f: jed.encode(jcfg, p, f.astype(jdt)))(
        params, jnp.asarray(frames))
    te = ted.encode(tcfg, model, torch.from_numpy(frames).to(
        getattr(torch, dtype)))
    _close(te, je, dtype, "encode")
    jk, jv = jed.project_enc_kv_stack(jcfg, params, je)
    tkv = ted.project_enc_kv_stack(tcfg, model, te)
    for l, (tk, tv) in enumerate(tkv):
        _close(tk.transpose(1, 2), jk[l], dtype, f"enc k layer {l}")
        _close(tv.transpose(1, 2), jv[l], dtype, f"enc v layer {l}")


_jprefill = jax.jit(jm.prefill, static_argnums=0)
_jdecode = jax.jit(jm.decode_step, static_argnums=0)


def _jax_decode_cache(cfg, cache1, max_seq):
    """The reference's prefill cache widened to ``max_seq`` slots."""
    B, S = cache1["k"].shape[1], cache1["k"].shape[2]
    big = jm.init_cache(cfg, B, max_seq)
    for name in ("k", "v"):
        big[name] = big[name].at[:, :, :S].set(cache1[name].astype(
            big[name].dtype))
    big["enc_kv"] = cache1["enc_kv"]
    big["len"] = cache1["len"]
    return big


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    jcfg, tcfg, params, model = _setup(dtype)
    B, S, n_decode = 2, 12, 6
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(jcfg, B, seed=3)
    lj, cj = _jprefill(jcfg, params, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(frames)})
    lt, ct = tm.prefill(tcfg, model, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)})
    _close(lt, lj, dtype, "prefill logits")
    ct_np = convert.cache_to_numpy(tcfg, ct)
    for name in ("k", "v"):
        _close(ct_np[name], cj[name], dtype, f"prefill cache {name}")
    for got, want in zip(ct_np["enc_kv"], cj["enc_kv"]):
        _close(got, want, dtype, "prefill cache enc_kv")
    np.testing.assert_array_equal(ct_np["len"], np.asarray(cj["len"]))

    jc = _jax_decode_cache(jcfg, cj, S + n_decode + 3)
    tc = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for step in range(n_decode):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, jc = _jdecode(jcfg, params, jc, jnp.asarray(tok))
        lt, tc = tm.decode_step(tcfg, model, tc, torch.from_numpy(tok))
        _close(lt, lj, dtype, f"decode step {step} logits")
    tc_np = convert.cache_to_numpy(tcfg, tc)
    for name in ("k", "v"):
        _close(tc_np[name], jc[name], dtype, f"decode cache {name}")
    np.testing.assert_array_equal(tc_np["len"], np.asarray(jc["len"]))


def test_init_params_draws_from_the_generator():
    _, cfg = _cfgs("bfloat16")
    a = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tm.init_params(cfg, device="cpu")
    c = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(a, ted.EncDec)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pb[k], pc[k]) for k in pb)
    assert not torch.equal(pa["embed.tok"], pb["embed.tok"])
    assert pa["decoder.1.cross_attn.wq"].dtype == torch.bfloat16
    assert torch.equal(pa["encoder.0.ln1.w"], torch.ones(64,
                                                         dtype=torch.bfloat16))
    assert not any(p.requires_grad for p in a.parameters())
    assert tm.device_of(a) == torch.device("cpu")


def test_serve_cli_refuses_an_encoder_decoder():
    args = tserve.parse_args(["--arch", ARCH, "--tiny", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserve.build(args)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"remat": "full", "logit_chunk": 4}],
                         ids=str)
def test_loss_and_grads_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    params = jax.tree.map(np.asarray, jm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    batch = _batch(jcfg, 2, 8)
    (jl, jmet), jg = jax.value_and_grad(      # op by op: no compile
        lambda p, b: jm.loss_fn(jcfg, p, b), has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    model = convert.params_from_numpy(tcfg, params, "cpu")
    model.requires_grad_(True)
    tl, tmet, tg = _port_grads(tcfg, model, batch)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    want = _flat(jg)
    assert set(tg) == set(want)
    for k, g in tg.items():
        lim = 1e-4 * max(1.0, float(np.abs(want[k]).max()))
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= lim, f"{k}: max|d| {err} over {lim}"
    # the encoder's attention (K5's path) reaches the loss
    assert float(tg["encoder/attn/wq"].abs().max()) > 0


def test_three_adamw_steps_match_jax():
    jcfg, tcfg = _cfgs()
    kw = dict(optimizer="adamw", warmup_steps=2, learning_rate=1e-2)
    jtc, ttc = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    js = jt.init_state(jcfg, jtc, jax.random.PRNGKey(0))
    ts = tt.state_of(tcfg, ttc, convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, js["params"]), "cpu"))
    jstep = jax.jit(jt.make_train_step(jcfg, jtc))
    jgrads = jax.jit(lambda p, b: jts._grads_plain(jcfg, p, b, 1)[2])
    tstep = tt.make_train_step(tcfg, ttc)
    small, lr_sum = {}, 0.0
    for i in range(3):
        batch = _batch(jcfg, 4, 8, seed=i)
        jb = jax.tree.map(jnp.asarray, batch)
        for k, g in _flat(jgrads(js["params"], jb)).items():
            near = np.abs(g) <= 1e-4 * np.abs(g).max()
            small[k] = small.get(k, False) | near
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, batch)
        lr_sum += float(jmet["lr"])
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= \
                1e-5 * abs(float(jmet[k])), (i, k)
    want = _flat(js["params"])
    n_small = n_all = 0
    for k, leaf in convert.param_leaves(tcfg, ts["params"]).items():
        d = np.abs(convert.stack_leaf(leaf).numpy() - want[k])
        lim = 2e-5 * max(1.0, float(np.abs(want[k]).max()))
        near = small.get(k, np.zeros(d.shape, bool))
        assert float(d[~near].max(initial=0.0)) <= lim, k
        assert float(d[near].max(initial=0.0)) <= 3 * lr_sum + lim, k
        n_small, n_all = n_small + int(near.sum()), n_all + d.size
    assert n_small <= 0.02 * n_all
