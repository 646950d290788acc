"""The port's rwkv6 slice on the CPU against the JAX package.

* K6's plain version (``repro_torch.kernels.ref.rwkv6_scan_ref``, what the
  ``rwkv6_scan`` wrapper runs on a CPU tensor) against JAX's
  ``ref.rwkv6_scan_ref`` and the Pallas ``rwkv6_scan`` in interpret mode,
  f32 within 3e-5, with and without an initial state, over two decay
  ranges; ``ops.wkv`` against JAX's ``ops.wkv`` and the model's own
  ``_wkv_chunk_scan``; the wrapper's refusals (meta tensors).
* The model functions of ``repro_torch.models.rwkv6`` against
  ``repro.models.rwkv6`` on the same numpy inputs, and the tiny
  ``rwkv6-1.6b`` with JAX's parameters carried over: prefill logits and
  cache, then six decode steps within 1e-4 in f32 and, in bf16, within
  5e-2 of each tensor's largest magnitude (at least 1): the two frameworks
  round their bf16 products at other places, and the wkv state sums those
  products over the prompt (it reaches |S| = 30-40; read over three seeds:
  logits within 1.2-1.7 %, the shifts 0.8-1.4 %, wkv 0.6-0.7 % of their
  magnitude).  Decode runs the
  channel-mix with no shift state, as the reference does.  The reference
  initialises the time-mix's groupnorm weight and bias to zero, which
  makes the time-mix output, and so the logits, independent of the WKV
  scan; every test here draws them from a seed instead (:func:`_live`), so
  that the scan shows in the logits.
* The serving loop on the tiny rwkv6, token for token and statistic for
  statistic, and the CLI.

The CUDA kernel runs only on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import base as jbase
from repro.configs import catalog as jcatalog
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan
from repro.models import rwkv6 as jrwkv
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro_torch import models as tm
from repro_torch.configs import base as tbase
from repro_torch.configs import catalog as tcatalog
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import rwkv6 as trwkv
from repro_torch.serve import ContinuousBatcher, DecodeEngine, Request

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
F32 = dict(atol=3e-5, rtol=3e-5)
#: The decay ranges: the whole of (0, 1) short of 0.01, and a slow one.
W_RANGES = {"wide": (0.01, 1.0), "slow": (0.6, 0.999)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scan_inputs(BH, T, n, w_range, with_s0, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(*w_range, (BH, T, n)).astype(np.float32)
    u = rng.standard_normal((BH, n)).astype(np.float32)
    s0 = (rng.standard_normal((BH, n, n)).astype(np.float32) if with_s0
          else None)
    return r, k, v, w, u, s0


def _opt(f, a):
    return None if a is None else f(a)


def _live(att, seed):
    """The time-mix parameters ``att`` (numpy, leaves of any leading
    shape) with the groupnorm weight and bias drawn from ``seed`` in place
    of the reference's zeros."""
    rng = np.random.default_rng(seed)
    shape = np.shape(att["ln_w"])
    return dict(att, ln_w=(1.0 + 0.2 * rng.standard_normal(shape)).astype(
        np.float32), ln_b=(0.1 * rng.standard_normal(shape)).astype(
        np.float32))


def _jax_params(cfg, seed):
    """JAX's parameters of ``cfg`` with every time-mix made live."""
    params = jm.init_params(cfg, jax.random.PRNGKey(seed))
    stack = tuple(dict(e, rwkv=jax.tree.map(
        jnp.asarray, _live(jax.tree.map(np.asarray, e["rwkv"]), seed + j)))
        for j, e in enumerate(params["stack"]))
    return dict(params, stack=stack)


# --------------------------------------------------------------------------
# K6's plain version and the layout wrapper
# --------------------------------------------------------------------------
@pytest.mark.parametrize("w_range", list(W_RANGES))
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("T", [1, 7, 64, 130])
@pytest.mark.parametrize("against", ["jax_ref", "pallas"])
def test_rwkv6_scan_ref_matches_jax(against, T, with_s0, w_range):
    arrays = _scan_inputs(3, T, 16, W_RANGES[w_range], with_s0)
    *t, ts0 = (_opt(torch.from_numpy, a) for a in arrays)
    *j, js0 = (_opt(jnp.asarray, a) for a in arrays)
    y, sT = rwkv6_scan(*t, ts0)
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (3, T, 16) and sT.shape == (3, 16, 16)
    if against == "jax_ref":
        wy, wsT = jref.rwkv6_scan_ref(*j, js0)
    else:
        wy, wsT = pallas_rwkv6_scan(*j, js0, chunk=64, interpret=True)
    np.testing.assert_allclose(_np(y), _np(wy), **F32)
    np.testing.assert_allclose(_np(sT), _np(wsT), **F32)


def test_rwkv6_scan_ref_at_the_catalog_head_dim():
    """n = 64, the head dim every rwkv6-1.6b layer scans with."""
    arrays = _scan_inputs(2, 33, 64, W_RANGES["slow"], True, seed=1)
    y, sT = rwkv6_scan(*(torch.from_numpy(a) for a in arrays))
    wy, wsT = jref.rwkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_np(y), _np(wy), **F32)
    np.testing.assert_allclose(_np(sT), _np(wsT), **F32)


def test_rwkv6_scan_ref_takes_bf16_inputs_as_f32():
    """The plain version casts, as JAX's: bf16 r / k / v give f32 out."""
    r, k, v, w, u, _ = _scan_inputs(2, 9, 16, W_RANGES["wide"], False)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    y, sT = ref.rwkv6_scan_ref(*tb, torch.from_numpy(w), torch.from_numpy(u))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    wy, wsT = jref.rwkv6_scan_ref(*jb, jnp.asarray(w), jnp.asarray(u))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(wy), **F32)
    np.testing.assert_allclose(_np(sT), _np(wsT), **F32)


def test_rwkv6_scan_ref_of_no_steps_returns_the_state():
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _scan_inputs(2, 0, 16, W_RANGES["wide"], True))
    y, sT = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    assert y.shape == (2, 0, 16) and torch.equal(sT, s0)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("against", ["jax_ops", "model_chunk_scan"])
def test_ops_wkv_matches_jax(against, with_s0):
    """Model layout (B, T, D) -> K6's (B*H, T, n) and back, u broadcast."""
    rng = np.random.default_rng(3)
    B, T, D, n = 2, 37, 48, 16
    r, k, v = (rng.standard_normal((B, T, D)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.7, 0.99, (B, T, D)).astype(np.float32)
    u = rng.standard_normal(D).astype(np.float32)
    s0 = (rng.standard_normal((B, D // n, n, n)).astype(np.float32)
          if with_s0 else None)
    y, sT = ops.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u)), n,
                    s0=_opt(torch.from_numpy, s0))
    assert y.shape == (B, T, D) and sT.shape == (B, D // n, n, n)
    j = [jnp.asarray(a) for a in (r, k, v, w, u)]
    js0 = _opt(jnp.asarray, s0)
    if against == "jax_ops":
        wy, wsT = jops.wkv(*j, head_dim=n, s0=js0)
    else:
        wy, wsT = jrwkv._wkv_chunk_scan(*j, head_dim=n, chunk=16,
                                        state0=js0, return_state=True)
    np.testing.assert_allclose(_np(y), _np(wy), **F32)
    np.testing.assert_allclose(_np(sT), _np(wsT), **F32)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    arrays = [torch.from_numpy(a) for a in
              _scan_inputs(4, 20, 16, W_RANGES["wide"], True)]
    before = rwkv6_scan.launches
    for chunk in (1, 16, 64):
        y, sT = rwkv6_scan(*arrays, chunk=chunk)
        wy, wsT = ref.rwkv6_scan_ref(*arrays)
        assert torch.equal(y, wy) and torch.equal(sT, wsT)
    assert rwkv6_scan.launches == before


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _scan_args(BH=4, T=8, n=64, dtype=torch.float32, s0=True):
    return [_meta(BH, T, n, dtype=dtype) for _ in range(4)] \
        + [_meta(BH, n), _meta(BH, n, n) if s0 else None]


def _swap(args, i, t):
    return args[:i] + [t] + args[i + 1:]


@pytest.mark.parametrize("args,kw,err,match", [
    (_scan_args(dtype=torch.bfloat16), {}, TypeError, "float32"),
    (_swap(_scan_args(), 5, _meta(4, 64, 64, dtype=torch.bfloat16)), {},
     TypeError, "s0: dtype"),
    (_scan_args(n=32), {}, ValueError, "head dim n=32"),
    (_swap(_scan_args(), 1, _meta(4, 64, 8).transpose(1, 2)), {},
     ValueError, "k: not contiguous"),
    (_swap(_scan_args(), 2, _meta(4, 9, 64)), {}, ValueError,
     "does not match"),
    (_swap(_scan_args(), 4, _meta(64)), {}, ValueError, "u "),
    (_swap(_scan_args(), 5, _meta(4, 64, 32)), {}, ValueError, "s0 "),
    (_scan_args()[:4] + [_meta(4, 64)], {"chunk": 0}, ValueError, "chunk=0"),
    (_scan_args(), {"chunk": 129}, ValueError, "chunk=129"),
    (_scan_args(BH=0), {}, ValueError, "BH=0"),
    ([_meta(8, 64)] * 4 + [_meta(8, 64)], {}, ValueError, "B\\*heads"),
    (_scan_args(s0=False), {}, ValueError, "cuda or cpu"),
])
def test_rwkv6_scan_wrapper_refuses(args, kw, err, match):
    before = rwkv6_scan.launches
    with pytest.raises(err, match=match):
        rwkv6_scan(*args, **kw)
    assert rwkv6_scan.launches == before


# --------------------------------------------------------------------------
# The model functions
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rwkv_params():
    """JAX's parameters of one tiny rwkv6 layer (f32), as numpy."""
    cfg = jcatalog.tiny(jbase.get_config(ARCH))
    key = jax.random.PRNGKey(5)
    att = jrwkv.init_rwkv6(key, cfg.rwkv6, cfg.d_model, jnp.float32)
    ffn = jrwkv.init_rwkv_ffn(jax.random.fold_in(key, 1), cfg.d_model,
                              cfg.d_ff, jnp.float32)
    return (cfg, _live(jax.tree.map(np.asarray, att), 5),
            jax.tree.map(np.asarray, ffn))


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _close(got, want, tol, what):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        _np(g), _np(w), atol=tol, rtol=tol, err_msg=what), got, want)


@pytest.mark.parametrize("fn", ["ddlerp", "decay", "groupnorm",
                                "time_mix", "time_mix_state",
                                "channel_mix", "channel_mix_state",
                                "decode_step"])
def test_rwkv6_functions_match_jax(rwkv_params, fn):
    cfg, att_np, ffn_np = rwkv_params
    (ja, ta), (jf, tf) = _both(att_np), _both(ffn_np)
    rng = np.random.default_rng(7)
    B, T, D = 2, 11, cfg.d_model
    H, n = D // cfg.rwkv6.head_dim, cfg.rwkv6.head_dim
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    last = rng.standard_normal((B, D)).astype(np.float32)
    S = rng.standard_normal((B, H, n, n)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jl, tl = jnp.asarray(last), torch.from_numpy(last)
    jS, tS = jnp.asarray(S), torch.from_numpy(S)
    rc = cfg.rwkv6
    if fn == "ddlerp":
        got = trwkv._ddlerp(ta, tx, trwkv._token_shift(tx, tl))
        want = jrwkv._ddlerp(ja, jx, jrwkv._token_shift(jx, jl))
    elif fn == "decay":
        got, want = trwkv._decay(ta, tx), jrwkv._decay(ja, jx)
    elif fn == "groupnorm":
        w, b = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
        got = trwkv._groupnorm(tx * 3 + 1, torch.from_numpy(w),
                               torch.from_numpy(b), H)
        want = jrwkv._groupnorm(jx * 3 + 1, jnp.asarray(w), jnp.asarray(b),
                                H)
    elif fn == "time_mix":
        got = trwkv.rwkv6_forward(rc, ta, tx)
        want = jrwkv.rwkv6_forward(rc, ja, jx)
    elif fn == "time_mix_state":
        got = trwkv.rwkv6_forward(rc, ta, tx, shift_state=tl, wkv_state=tS,
                                  return_state=True)
        want = jrwkv.rwkv6_forward(rc, ja, jx, shift_state=jl, wkv_state=jS,
                                   return_state=True)
    elif fn == "channel_mix":
        got = trwkv.rwkv_ffn_forward(tf, tx)
        want = jrwkv.rwkv_ffn_forward(jf, jx)
    elif fn == "channel_mix_state":
        got = trwkv.rwkv_ffn_forward(tf, tx, shift_state=tl,
                                     return_state=True)
        want = jrwkv.rwkv_ffn_forward(jf, jx, shift_state=jl,
                                      return_state=True)
    else:
        norm = lambda h: h * 0.5
        tc = {"att_shift": tl, "ffn_shift": -tl, "wkv": tS}
        jc = {"att_shift": jl, "ffn_shift": -jl, "wkv": jS}
        got = trwkv.rwkv6_decode_step(rc, ta, tf, tx[:, :1], tc, norm, norm)
        want = jrwkv.rwkv6_decode_step(rc, ja, jf, jx[:, :1], jc, norm, norm)
    _close(got, want, 1e-4, fn)


def test_rwkv6_init_shapes_dtypes_and_decay_range():
    jcfg = jcatalog.tiny(jbase.get_config(ARCH))
    cfg = tcatalog.tiny(tbase.get_config(ARCH))
    D = cfg.d_model
    ta = trwkv.init_rwkv6(torch.Generator().manual_seed(0), cfg.rwkv6, D,
                          torch.bfloat16, "cpu")
    tf = trwkv.init_rwkv_ffn(torch.Generator().manual_seed(0), D, cfg.d_ff,
                             torch.bfloat16, "cpu")
    ja = jrwkv.init_rwkv6(jax.random.PRNGKey(0), jcfg.rwkv6, D, jnp.bfloat16)
    jf = jrwkv.init_rwkv_ffn(jax.random.PRNGKey(0), D, jcfg.d_ff,
                             jnp.bfloat16)
    for t, j in ((ta, ja), (tf, jf)):
        assert t.keys() == j.keys()
        for name in t:
            assert tuple(t[name].shape) == j[name].shape, name
            assert str(t[name].dtype).split(".")[1] == j[name].dtype.name
    # w0 = N(0, 0.02^2) - 6, so the decay sits near exp(-exp(-6))
    assert abs(float(ta["w0"].mean()) + 6.0) < 0.01
    assert not ta["ln_w"].any() and not ta["ln_b"].any()


# --------------------------------------------------------------------------
# The tiny rwkv6-1.6b against repro.models
# --------------------------------------------------------------------------
def _cfgs(dtype):
    j = jcatalog.tiny(jbase.get_config(ARCH)).replace(dtype=dtype,
                                                       param_dtype=dtype)
    t = tcatalog.tiny(tbase.get_config(ARCH)).replace(dtype=dtype,
                                                       param_dtype=dtype)
    return j, t


_jprefill = jax.jit(jm.prefill, static_argnums=0)
_jdecode = jax.jit(jm.decode_step, static_argnums=0)
STATES = ("att_shift", "ffn_shift", "wkv")


def _within(got, want, tol, scaled, what):
    """f32: allclose at ``tol``; ``scaled`` (bf16): max|got - want| at
    most ``tol`` times max(1, max|want|).  Returns max|d| / that scale."""
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max())) if scaled else 1.0
    err = float(np.abs(got - want).max()) / scale
    if scaled:
        assert err <= tol, f"{what}: max|d| {err} x {scale}"
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=what)
    return err


def _close_cache(tc, jc, tcfg, tol, what, scaled=False):
    got = convert.cache_to_numpy(tcfg, tc)
    assert got["stack"][0].keys() == jc["stack"][0].keys() == set(STATES)
    np.testing.assert_array_equal(got["len"], np.asarray(jc["len"]))
    return max(_within(got["stack"][0][name], jc["stack"][0][name], tol,
                       scaled, f"{what} {name}") for name in STATES)


def _run_both(dtype, B, S, n_decode, tol, seed=0):
    """Prefill, then ``n_decode`` steps; the largest difference seen
    (scaled in bf16, see :func:`_within`)."""
    scaled = dtype == "bfloat16"
    jcfg, tcfg = _cfgs(dtype)
    params = _jax_params(jcfg, seed)
    model = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, jc = _jprefill(jcfg, params, {"tokens": jnp.asarray(toks)})
    lt, tc = tm.prefill(tcfg, model, {"tokens": torch.from_numpy(toks)})
    worst = max(_within(lt, lj, tol, scaled, "prefill logits"),
                _close_cache(tc, jc, tcfg, tol, "prefill cache", scaled))
    # the prefill cache is the decode cache: rwkv6 keeps no positions
    tc = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for step in range(n_decode):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, jc = _jdecode(jcfg, params, jc, jnp.asarray(tok))
        lt, tc = tm.decode_step(tcfg, model, tc, torch.from_numpy(tok))
        worst = max(worst,
                    _within(lt, lj, tol, scaled, f"step {step} logits"),
                    _close_cache(tc, jc, tcfg, tol, f"step {step} cache",
                                 scaled))
    return worst


def test_prefill_and_decode_match_jax_f32():
    _run_both("float32", B=2, S=40, n_decode=6, tol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_match_jax_bf16(seed):
    _run_both("bfloat16", B=2, S=24, n_decode=6, tol=5e-2, seed=seed)


def test_decode_channel_mix_reads_no_shift_state():
    """The reference's decode runs the channel-mix without its cached
    shift (transformer.py, _decode_layer): ``ffn_shift`` is written and
    never read, in both packages, while ``att_shift`` is read."""
    jcfg, tcfg = _cfgs("float32")
    params = _jax_params(jcfg, 2)
    model = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 6)).astype(np.int32)
    _, jc = _jprefill(jcfg, params, {"tokens": jnp.asarray(toks)})
    tok = toks[:, -1:]

    def both(change):
        jcc = {"stack": tuple(dict(e, **{change: e[change] + 1.0})
                              if change else e for e in jc["stack"]),
               "len": jc["len"]}
        tc = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jcc),
                                      "cpu")
        lj, _ = _jdecode(jcfg, params, jcc, jnp.asarray(tok))
        lt, tc = tm.decode_step(tcfg, model, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-4, rtol=1e-4)
        return _np(lt), tc

    base, tc = both(None)
    shifted, _ = both("ffn_shift")
    np.testing.assert_array_equal(shifted, base)
    moved, _ = both("att_shift")
    assert np.abs(moved - base).max() > 1e-3
    # what decode writes there is the channel-mix input of the new token
    assert all(c["ffn_shift"].shape == (2, tcfg.d_model)
               for c in tc["layers"])


def test_rwkv6_layers_hold_their_parts():
    """(Parameter counts: tests/test_torch_models.py.)"""
    model = tm.init_params(tcatalog.tiny(tbase.get_config(ARCH)),
                           device="cpu")
    assert {n.split(".")[2] for n, _ in model.named_parameters()
            if n.startswith("layers.0.") and n.count(".") > 2} == \
        {"rwkv", "rwkvffn"}


def test_rwkv6_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    tiny = tcatalog.tiny(tbase.get_config(ARCH))
    for call in (lambda: tm.init_params(tiny),
                 lambda: tm.init_cache(tiny, 1, 8),
                 lambda: tserve.main(["--arch", ARCH, "--tiny",
                                      "--requests", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------
SLOTS, MAX_SEQ, MAX_NEW, N_REQ = 3, 32, 6, 8


@pytest.fixture(scope="module")
def tiny_rwkv():
    jcfg, tcfg = _cfgs("float32")
    params = _jax_params(jcfg, 0)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params), {}


def _drain(batcher_cls, engine, req_cls, policy, prompts):
    bat = batcher_cls.from_policy(engine, policy)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        bat.submit(r)
    stats = bat.run_until_drained(max_steps=500)
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("policy", ["mutable", "zero", "max"])
def test_engine_and_batcher_match_jax(tiny_rwkv, policy):
    jcfg, tcfg, params, np_params, jitted = tiny_rwkv
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(2, jcfg.vocab_size - 1,
                                          size=int(rng.choice([5, 9])))))
               for _ in range(N_REQ)]
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
    # the states agree after the drain, the idle slots' included
    _close_cache(teng.cache, jax.tree.map(np.asarray, jeng.cache), tcfg,
                 1e-4, "drained engine")


def test_insert_copies_every_state_into_its_slot(tiny_rwkv):
    _, tcfg, _, np_params, _ = tiny_rwkv
    eng = DecodeEngine(tcfg, convert.params_from_numpy(tcfg, np_params,
                                                        "cpu"),
                       max_slots=3, max_seq=16, device="cpu")
    tok, cache1 = eng.prefill([5, 6, 7, 8])
    eng.insert(1, cache1, 4, tok, Request(0, [5, 6, 7, 8], 2))
    for big, small in zip(eng.cache["layers"], cache1["layers"]):
        assert big.keys() == small.keys() == set(STATES)
        for name in STATES:
            assert torch.equal(big[name][1], small[name][0])
            assert not big[name][0].any() and not big[name][2].any()
    assert eng.cache["len"].tolist() == [0, 4, 0]


def test_serve_cli_runs_rwkv6_on_cpu(capsys):
    s = tserve.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                     "--requests", "5", "--slots", "2", "--max-new", "4"])
    assert s["completed"] == 5
    out = capsys.readouterr().out
    assert "served 5 requests / 20 tokens" in out
