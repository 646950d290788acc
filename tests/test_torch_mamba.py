"""The port's mamba + MoE slice on the CPU against the JAX package.

* K7's plain version (``repro_torch.kernels.ref.mamba_scan_ref``, what the
  ``mamba_scan`` wrapper runs on a CPU tensor) and ``ops.selective_scan``
  against JAX's ``ref.mamba_scan_ref``, the Pallas ``mamba_scan`` in
  interpret mode and the model's own ``_ssm_chunk_scan``, f32 within 3e-5,
  over the JAX kernel tests' shapes (T and d that the Pallas wrapper pads)
  and two dt ranges; the final state against JAX's reference scan read out
  one state column at a time; the wrapper's refusals (meta tensors).
* The model functions of ``repro_torch.models.mamba`` and
  ``repro_torch.models.moe`` against their twins on the same numpy inputs
  (1e-4 in f32), the prefill state against the reference's
  ``_mamba_with_state`` / ``_mamba_final_state``.  MoE expert ids are
  compared only where the k-th and (k+1)-th router probabilities differ by
  more than ``MARGIN``: there the two frameworks' f32 softmaxes (about
  1e-7 apart) cannot pick differently.
* ``tiny(jamba)``, ``tiny(granite-moe-1b-a400m)`` and
  ``tiny(qwen3-moe-235b-a22b)`` with JAX's parameters carried over: prefill
  logits and cache, then six decode steps, within 1e-4 in f32 and, in
  bf16, within 5e-2 of each tensor's largest magnitude (at least 1), as
  for rwkv6 (ROADMAP C9).
* The serving loop on the tiny jamba, token for token and statistic for
  statistic, the CLI, and the conv state of a prompt shorter than the
  convolution (ROADMAP C11).

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
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models.transformer import _mamba_with_state
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro_torch import models as tm
from repro_torch.configs import base as tbase
from repro_torch.configs import catalog as tcatalog
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.serve import ContinuousBatcher, DecodeEngine, Request

torch.set_num_threads(1)

JAMBA = "jamba-1.5-large-398b"
MOE_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
F32 = dict(atol=3e-5, rtol=3e-5)
#: dt ranges: the model's (softplus of its init bias, 1e-3 to 0.1) and a
#: wide one that decays the state within a few steps.
DT_RANGES = {"model": (1e-3, 0.1), "wide": (1e-3, 1.0)}
#: The JAX kernel tests' shapes (B, T, d, N) with the Pallas chunk and
#: block_d (the second pads both T and d), and the tiny jamba's d_in / N.
SHAPES = [(2, 64, 32, 8, 32, 16), (1, 100, 48, 16, 64, 32),
          (2, 32, 16, 4, 32, 16), (2, 13, 128, 4, 8, 128)]
#: Router-probability gap under which an expert id may differ: f32 inputs
#: alike, and bf16 runs of the two packages.
MARGIN = 1e-5
BF16_MARGIN = 1e-3
#: The per-layer bf16 tests scale each difference by the tensor's own
#: magnitude; this only keeps an all-zero tensor from dividing by zero.
LAYER_FLOOR = 1e-30


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scan_inputs(B, T, d, N, dt_range, seed=0):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(*dt_range, (B, T, d)).astype(np.float32)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (d, N)).astype(np.float32)
    return dt, x, Bm, Cm, a


def _jax_final_state(dt, x, Bm, Cm, a):
    """s_T of JAX's reference scan: y at the last step with C_T = e_n is
    column n of the state."""
    N = a.shape[1]
    cols = []
    for n in range(N):
        C = np.array(Cm)
        C[:, -1] = np.eye(N, dtype=np.float32)[n]
        y = jref.mamba_scan_ref(*(jnp.asarray(v) for v in (dt, x, Bm, C, a)))
        cols.append(_np(y)[:, -1])
    return np.stack(cols, axis=-1)


# --------------------------------------------------------------------------
# K7's plain version and the layout wrapper
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dt_range", list(DT_RANGES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("against", ["jax_ref", "pallas", "chunk_scan"])
def test_mamba_scan_ref_matches_jax(against, shape, dt_range):
    B, T, d, N, chunk, block_d = shape
    arrays = _scan_inputs(B, T, d, N, DT_RANGES[dt_range])
    y, sT = mamba_scan(*(torch.from_numpy(v) for v in arrays))
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, T, d) and sT.shape == (B, d, N)
    dt, x, Bm, Cm, a = (jnp.asarray(v) for v in arrays)
    if against == "jax_ref":
        want = jref.mamba_scan_ref(dt, x, Bm, Cm, a)
        np.testing.assert_allclose(_np(sT), _jax_final_state(*arrays), **F32)
    elif against == "pallas":
        want = pallas_mamba_scan(dt, x, Bm, Cm, a, chunk=chunk,
                                 block_d=block_d, interpret=True)
    else:
        want = jmamba._ssm_chunk_scan(dt, Bm, Cm, x, a, chunk)
    np.testing.assert_allclose(_np(y), _np(want), **F32)


@pytest.mark.parametrize("dt_range", list(DT_RANGES))
def test_ops_selective_scan_matches_jax(dt_range):
    """y against JAX's ``ops.selective_scan``; the final state, which JAX's
    does not return, against its reference scan."""
    arrays = _scan_inputs(2, 37, 48, 8, DT_RANGES[dt_range], seed=3)
    y, sT = ops.selective_scan(*(torch.from_numpy(v) for v in arrays))
    want = jops.selective_scan(*(jnp.asarray(v) for v in arrays))
    np.testing.assert_allclose(_np(y), _np(want), **F32)
    np.testing.assert_allclose(_np(sT), _jax_final_state(*arrays), **F32)


def test_mamba_scan_ref_takes_bf16_inputs_as_f32():
    """The plain version casts, as JAX's: bf16 dt / x give f32 out."""
    dt, x, Bm, Cm, a = _scan_inputs(2, 9, 16, 4, DT_RANGES["model"])
    y, _ = ref.mamba_scan_ref(torch.from_numpy(dt).bfloat16(),
                              torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(Bm), torch.from_numpy(Cm),
                              torch.from_numpy(a))
    want = jref.mamba_scan_ref(jnp.asarray(dt, jnp.bfloat16),
                               jnp.asarray(x, jnp.bfloat16), jnp.asarray(Bm),
                               jnp.asarray(Cm), jnp.asarray(a))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want), **F32)


def test_mamba_scan_ref_of_no_steps_returns_the_zero_state():
    arrays = [torch.from_numpy(v) for v in
              _scan_inputs(2, 0, 16, 4, DT_RANGES["model"])]
    y, sT = ref.mamba_scan_ref(*arrays)
    assert y.shape == (2, 0, 16) and sT.shape == (2, 16, 4)
    assert not sT.any()


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    arrays = [torch.from_numpy(v) for v in
              _scan_inputs(2, 20, 48, 16, DT_RANGES["wide"])]
    before = mamba_scan.launches
    for chunk in (1, 16, 64):
        y, sT = mamba_scan(*arrays, chunk=chunk)
        wy, wsT = ref.mamba_scan_ref(*arrays)
        assert torch.equal(y, wy) and torch.equal(sT, wsT)
    assert mamba_scan.launches == before


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _args(B=2, T=8, d=256, N=16, dtype=torch.float32):
    return [_meta(B, T, d, dtype=dtype), _meta(B, T, d, dtype=dtype),
            _meta(B, T, N), _meta(B, T, N), _meta(d, N)]


def _swap(args, i, t):
    return args[:i] + [t] + args[i + 1:]


@pytest.mark.parametrize("args,kw,err,match", [
    (_args(dtype=torch.bfloat16), {}, TypeError, "float32"),
    (_swap(_args(), 4, _meta(256, 16, dtype=torch.bfloat16)), {}, TypeError,
     "a: dtype"),
    (_args(N=32), {}, ValueError, "state size N=32"),
    (_swap(_args(), 1, _meta(2, 256, 8).transpose(1, 2)), {}, ValueError,
     "x: not contiguous"),
    (_swap(_args(), 0, _meta(2, 9, 256)), {}, ValueError, "dt .* does not "
     "match"),
    (_swap(_args(), 3, _meta(2, 8, 8)), {}, ValueError, "Cm "),
    (_swap(_args(), 4, _meta(128, 16)), {}, ValueError, "a "),
    (_args(), {"chunk": 0}, ValueError, "chunk=0"),
    (_args(), {"chunk": 129}, ValueError, "chunk=129"),
    (_args(B=0), {}, ValueError, "B=0"),
    (_args(d=0), {}, ValueError, "d=0"),
    ([_meta(8, 256)] * 4 + [_meta(256, 16)], {}, ValueError, "expected"),
    (_args(), {}, ValueError, "cuda or cpu"),
])
def test_mamba_scan_wrapper_refuses(args, kw, err, match):
    before = mamba_scan.launches
    with pytest.raises(err, match=match):
        mamba_scan(*args, **kw)
    assert mamba_scan.launches == before


# --------------------------------------------------------------------------
# The model functions
# --------------------------------------------------------------------------
def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _close(got, want, tol, what):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        _np(g), _np(w), atol=tol, rtol=tol, err_msg=what), got, want)


@pytest.fixture(scope="module")
def mamba_layer():
    """JAX's parameters of one tiny jamba mamba mixer (f32), as numpy."""
    cfg = jcatalog.tiny(jbase.get_config(JAMBA)).replace(
        dtype="float32", param_dtype="float32")
    p = jmamba.init_mamba(jax.random.PRNGKey(5), cfg.mamba, cfg.d_model,
                          jnp.float32)
    p = jax.tree.map(np.asarray, p)
    # a live norm weight and conv bias in place of the reference's zeros
    rng = np.random.default_rng(5)
    p = dict(p, norm=(0.3 * rng.standard_normal(p["norm"].shape)).astype(
        np.float32), conv_b=(0.1 * rng.standard_normal(
            p["conv_b"].shape)).astype(np.float32))
    return cfg, p


@pytest.mark.parametrize("fn", ["causal_conv", "forward", "prefill_state",
                                "decode_step", "dt_bias_range"])
def test_mamba_functions_match_jax(mamba_layer, fn):
    cfg, p_np = mamba_layer
    jp, tp = _both(p_np)
    mc = cfg.mamba
    rng = np.random.default_rng(7)
    B, T, D = 2, 21, cfg.d_model
    d_in, N = mc.expand * D, mc.d_state
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if fn == "causal_conv":
        h = rng.standard_normal((B, T, d_in)).astype(np.float32)
        got = tmamba._causal_conv(torch.from_numpy(h), tp["conv_w"],
                                  tp["conv_b"])
        want = jmamba._causal_conv(jnp.asarray(h), jp["conv_w"],
                                   jp["conv_b"])
    elif fn == "forward":
        got = tmamba.mamba_forward(mc, tp, tx)[0]
        want = jmamba.mamba_forward(mc, jp, jx)
    elif fn == "prefill_state":
        # the reference's prefill hand-off: conv window and a second scan
        # for the final state (_mamba_final_state); the port's one pass
        got = tmamba.mamba_forward(mc, tp, tx)
        want = _mamba_with_state(cfg, jp, jx)
        assert got[1].keys() == want[1].keys() == {"conv", "ssm"}
        assert float(np.abs(_np(want[1]["ssm"])).max()) > 1e-3
    elif fn == "decode_step":
        conv = rng.standard_normal((B, mc.d_conv - 1, d_in)).astype(np.float32)
        ssm = rng.standard_normal((B, d_in, N)).astype(np.float32)
        got = tmamba.mamba_decode_step(mc, tp, tx[:, :1], {
            "conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)})
        want = jmamba.mamba_decode_step(mc, jp, jx[:, :1], {
            "conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)})
    else:
        # softplus(dt_bias) is dt in [1e-3, 0.1], log-uniform, in both
        tb = tmamba._dt_bias_init(torch.Generator().manual_seed(0), 4096,
                                  "cpu")
        jb = jmamba._dt_bias_init(jax.random.PRNGKey(0), 4096)
        for b in (_np(tb), _np(jb)):
            dt = np.log1p(np.exp(b))
            assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (
                1 + 1e-5)
            assert abs(np.log(dt).mean() - np.log(1e-3 * 0.1) / 2) < 0.1
        return
    _close(got, want, 1e-4, fn)


def test_mamba_and_moe_init_shapes_and_dtypes():
    jcfg = jcatalog.tiny(jbase.get_config(JAMBA))
    cfg = tcatalog.tiny(tbase.get_config(JAMBA))
    D = cfg.d_model
    gen = torch.Generator().manual_seed(0)
    tmam = tmamba.init_mamba(gen, cfg.mamba, D, torch.bfloat16, "cpu")
    tmo = tmoe.init_moe(gen, cfg.moe, D, torch.bfloat16, "cpu")
    jmam = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg.mamba, D,
                             jnp.bfloat16)
    jmo = jmoe.init_moe(jax.random.PRNGKey(0), jcfg.moe, D, jnp.bfloat16)
    for t, j in ((tmam, jmam), (tmo, jmo)):
        assert t.keys() == j.keys()
        for name in t:
            assert tuple(t[name].shape) == j[name].shape, name
            assert str(t[name].dtype).split(".")[1] == j[name].dtype.name
    np.testing.assert_array_equal(_np(tmam["a_log"]), _np(jmam["a_log"]))
    assert not tmam["norm"].any() and torch.equal(
        tmam["d"], torch.ones_like(tmam["d"]))
    assert tmamba.dt_rank_of(cfg.mamba, D) == jmamba.dt_rank_of(jcfg.mamba, D)
    assert tmamba.dt_rank_of(cfg.mamba.__class__(), 8192) == 512


@pytest.fixture(scope="module")
def moe_layer():
    """JAX's parameters of one MoE FFN (f32, 8 experts of which 2 are
    picked, a shared expert), as numpy."""
    mcfg = jbase.MoEConfig(num_experts=8, top_k=2, d_ff=24, shared_d_ff=16)
    p = jmoe.init_moe(jax.random.PRNGKey(9), mcfg, 32, jnp.float32)
    return mcfg, jax.tree.map(np.asarray, p)


def _t_moe(p_np):
    flat = {k: v for k, v in p_np.items() if k != "shared"}
    flat.update({f"shared_{k}": v for k, v in p_np.get("shared", {}).items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _tcfg(jcfg, **kw):
    return tbase.MoEConfig(**{**jcfg.__dict__, **kw})


@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_route_matches_jax_where_the_margin_is_clear(moe_layer, softcap):
    jcfg, p_np = moe_layer
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "router_logit_softcap": softcap})
    tcfg = _tcfg(jcfg)
    rng = np.random.default_rng(11)
    tokens = rng.standard_normal((256, 32)).astype(np.float32)
    g, e, pr = tmoe.route(tcfg, torch.tensor(p_np["router"]),
                          torch.from_numpy(tokens))
    wg, we, wpr = jmoe.route(jcfg, jnp.asarray(p_np["router"]),
                             jnp.asarray(tokens))
    np.testing.assert_allclose(_np(pr), _np(wpr), atol=1e-6, rtol=1e-5)
    srt = np.sort(_np(wpr), axis=-1)[:, ::-1]
    clear = srt[:, jcfg.top_k - 1] - srt[:, jcfg.top_k] > MARGIN
    assert clear.sum() >= 250          # 256 tokens; the rest are near-ties
    np.testing.assert_array_equal(e.numpy()[clear], np.asarray(we)[clear])
    np.testing.assert_allclose(_np(g)[clear], _np(wg)[clear], atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_moe_dense_matches_jax(moe_layer, shared):
    jcfg, p_np = moe_layer
    if not shared:
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "shared_d_ff": 0})
        p_np = {k: v for k, v in p_np.items() if k != "shared"}
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 17, 32)).astype(np.float32)
    got = tmoe.moe_dense(_tcfg(jcfg), _t_moe(p_np), torch.from_numpy(x),
                         "silu")
    want, _ = jmoe.moe_dense(jcfg, jax.tree.map(jnp.asarray, p_np),
                             jnp.asarray(x), "silu", with_aux=False)
    srt = np.sort(_np(jmoe.route(jcfg, jnp.asarray(p_np["router"]),
                                 jnp.asarray(x.reshape(-1, 32)))[2]), -1)
    assert (srt[:, -2] - srt[:, -3] > MARGIN).all()   # no near-tie here
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# The tiny models against repro.models
# --------------------------------------------------------------------------
def _cfgs(arch, dtype):
    j = jcatalog.tiny(jbase.get_config(arch)).replace(dtype=dtype,
                                                       param_dtype=dtype)
    t = tcatalog.tiny(tbase.get_config(arch)).replace(dtype=dtype,
                                                       param_dtype=dtype)
    return j, t


_jprefill = jax.jit(jm.prefill, static_argnums=0)
_jdecode = jax.jit(jm.decode_step, static_argnums=0)


def _within(got, want, tol, scaled, what, floor=1.0):
    """f32: allclose at ``tol``; ``scaled`` (bf16): max|got - want| at
    most ``tol`` times max(floor, max|want|).  Returns max|d| / that
    scale."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(floor, float(np.abs(want).max())) if scaled else 1.0
    err = float(np.abs(got - want).max()) / scale
    if scaled:
        assert err <= tol, f"{what}: max|d| {err} x {scale}"
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=what)
    return err


def _close_cache(tc, jc, tcfg, tol, what, scaled=False):
    got = convert.cache_to_numpy(tcfg, tc)
    np.testing.assert_array_equal(got["len"], np.asarray(jc["len"]))
    worst = 0.0
    for j, (g, w) in enumerate(zip(got["stack"], jc["stack"])):
        assert g.keys() == w.keys(), (j, g.keys(), w.keys())
        for name in g:
            worst = max(worst, _within(g[name], w[name], tol, scaled,
                                       f"{what} position {j} {name}"))
    return worst


def _jax_decode_cache(cfg, cache1, max_seq):
    """The reference's prefill cache padded into an empty decode cache."""
    big = jm.init_cache(cfg, cache1["len"].shape[0], max_seq)

    def put(b, s):
        if b.shape == s.shape:
            return s.astype(b.dtype)
        return b.at[:, :, :s.shape[2]].set(s.astype(b.dtype))

    return {"stack": jax.tree.map(put, big["stack"], cache1["stack"]),
            "len": cache1["len"]}


def _run_both(arch, dtype, B, S, n_decode, tol, seed=0, caches=True):
    """Prefill, then ``n_decode`` steps; the largest difference seen
    (scaled in bf16, see :func:`_within`), over the logits and, with
    ``caches``, every cache tensor."""
    scaled = dtype == "bfloat16"
    jcfg, tcfg = _cfgs(arch, dtype)
    params = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = _jprefill(jcfg, params, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill(tcfg, model, {"tokens": torch.from_numpy(toks)})
    worst = _within(lt, lj, tol, scaled, f"{arch} prefill logits")
    if caches:
        worst = max(worst, _close_cache(ct, cj, tcfg, tol,
                                        f"{arch} prefill cache", scaled))
    jc = _jax_decode_cache(jcfg, cj, S + n_decode + 3)
    tc = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for step in range(n_decode):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, jc = _jdecode(jcfg, params, jc, jnp.asarray(tok))
        lt, tc = tm.decode_step(tcfg, model, tc, torch.from_numpy(tok))
        worst = max(worst, _within(lt, lj, tol, scaled,
                                   f"{arch} step {step} logits"))
        if caches:
            worst = max(worst, _close_cache(tc, jc, tcfg, tol,
                                            f"{arch} step {step} cache",
                                            scaled))
    return worst


@pytest.mark.parametrize("arch", (JAMBA,) + MOE_ARCHS)
def test_prefill_and_decode_match_jax_f32(arch):
    _run_both(arch, "float32", B=2, S=24, n_decode=6, tol=1e-4)


@pytest.fixture
def router_gaps(monkeypatch):
    """Every token's gap between its k-th and (k+1)-th router probability,
    recorded from the port's :func:`moe.route` while the test runs."""
    gaps = []
    real = tmoe.route

    def route(mcfg, router_w, tokens):
        out = real(mcfg, router_w, tokens)
        top = torch.topk(out[2], mcfg.top_k + 1, dim=-1).values
        gaps.append(top[:, -2] - top[:, -1])
        return out

    monkeypatch.setattr(tmoe, "route", route)
    return gaps


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax_bf16(arch, router_gaps):
    """C9's bf16 limit.  The hidden states of the two frameworks differ by
    about one bf16 ulp, which moves the router's probabilities by up to
    about 1e-3: a token whose k-th and (k+1)-th experts are nearer than
    ``BF16_MARGIN`` may be routed differently, and the comparison holds
    only where none is (the count is in the message)."""
    try:
        _run_both(arch, "bfloat16", B=2, S=16, n_decode=6, tol=5e-2)
    except AssertionError as e:
        gaps = torch.cat(router_gaps)
        near = int((gaps < BF16_MARGIN).sum())
        raise AssertionError(f"{e}\n({near} of {gaps.numel()} routings "
                             f"within {BF16_MARGIN})") from None


def test_prefill_and_decode_match_jax_bf16_jamba():
    """tiny(jamba) has 16 layers, and bf16 rounding compounds over them.
    Read over seeds 0-2, in % of each tensor's magnitude: the prefill
    logits of the two packages lie 3.6-6.7 apart, and each package's own
    lie up to 5.8 (port) / 9.9 (JAX) from the f32 logits on the same
    weights; the second period's attention k / v up to 21 apart, and 26 /
    16 from f32.  So the whole model is held by its logits within 1e-1
    (ROADMAP C11), and each layer with its cache entry, fed the
    reference's own input, within C9's 5e-2 (the next test)."""
    _run_both(JAMBA, "bfloat16", B=2, S=16, n_decode=6, tol=1e-1,
              caches=False)


def test_each_jamba_layer_matches_jax_bf16():
    """Every layer of tiny(jamba) in bf16, fed the reference's own input:
    its output and its prefill cache entry within 5e-2 of their magnitude
    (C9), so no layer kind (mamba, attention, MoE, dense) adds more than
    rounding.  The magnitude is each tensor's own, without C9's floor of 1:
    the mamba states lie near 5e-4, where that floor would hold nothing."""
    from repro.models.transformer import _apply_layer as j_apply
    from repro.models.transformer import layer_schedules as j_schedules
    from repro_torch.models.transformer import _apply_layer as t_apply
    jcfg, tcfg = _cfgs(JAMBA, "bfloat16")
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    h = params["embed"]["tok"][jnp.asarray(toks)]
    positions = jnp.arange(16, dtype=jnp.int32)
    win, theta = j_schedules(jcfg)
    P = jcfg.layers_per_period
    for l, layer in enumerate(model.layers):
        j, p = l % P, l // P
        lp = jax.tree.map(lambda a: a[p], params["stack"][j])
        want, _, wc = j_apply(jcfg, jcfg.pattern[j], lp, h, positions,
                              win[p, j], theta[p, j], "prefill", True)
        got, tc = t_apply(tcfg, layer, torch.tensor(_np(h)).bfloat16(),
                          torch.arange(16), True)
        what = f"layer {l} ({jcfg.pattern[j]})"
        _within(got, want, 5e-2, True, what, LAYER_FLOOR)
        assert tc.keys() == wc.keys(), what
        for name, t in tc.items():
            t = t.transpose(1, 2) if name in ("k", "v") else t
            _within(t, wc[name], 5e-2, True, f"{what} {name}", LAYER_FLOOR)
        h = want


def test_each_jamba_layer_decode_step_matches_jax_bf16():
    """Every layer of tiny(jamba) in bf16 over three decode steps after a
    16-token prefill, fed the reference's own input and cache: its output
    and its new cache entry (mamba conv / ssm, attention k / v) within
    5e-2 of their own magnitude (C9, without its floor, as in the prefill
    test), so the bf16 decode states of no layer kind drift more than
    rounding."""
    from repro.models.transformer import _decode_layer as j_decode
    from repro.models.transformer import layer_schedules as j_schedules
    from repro_torch.models.transformer import _decode_layer as t_decode
    jcfg, tcfg = _cfgs(JAMBA, "bfloat16")
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    _, cj = _jprefill(jcfg, params, {"tokens": jnp.asarray(toks)})
    jc = _jax_decode_cache(jcfg, cj, 16 + 3 + 3)
    win, theta = j_schedules(jcfg)
    P = jcfg.layers_per_period
    for step in range(3):
        tc = convert.cache_from_numpy(tcfg, jax.tree.map(np.asarray, jc),
                                      "cpu")
        new_len = jc["len"] + 1
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        h = params["embed"]["tok"][jnp.asarray(tok)]
        stack = [dict(e) for e in jc["stack"]]
        for l, layer in enumerate(model.layers):
            j, p = l % P, l // P
            lp = jax.tree.map(lambda a: a[p], params["stack"][j])
            lc = {n: a[p] for n, a in jc["stack"][j].items()}
            want, wc = j_decode(jcfg, jcfg.pattern[j], lp, lc, h, new_len,
                                win[p, j], theta[p, j])
            got, c = t_decode(tcfg, layer, tc["layers"][l],
                              torch.tensor(_np(h)).bfloat16(),
                              torch.tensor(np.asarray(new_len)))
            what = f"step {step} layer {l} ({jcfg.pattern[j]})"
            _within(got, want, 5e-2, True, what, LAYER_FLOOR)
            assert c.keys() == wc.keys(), what
            for name, t in c.items():
                t = t.transpose(1, 2) if name in ("k", "v") else t
                _within(t, wc[name], 5e-2, True, f"{what} {name}",
                        LAYER_FLOOR)
                stack[j][name] = stack[j][name].at[p].set(wc[name])
            h = want
        jc = {"stack": tuple(stack), "len": new_len}


def test_jamba_layers_hold_their_parts():
    """(Parameter counts: tests/test_torch_models.py.)"""
    cfg = tcatalog.tiny(tbase.get_config(JAMBA))
    model = tm.init_params(cfg, device="cpu")
    parts = [{n.split(".")[2] for n, _ in model.named_parameters()
              if n.startswith(f"layers.{l}.") and n.count(".") > 2}
             for l in range(cfg.layers_per_period)]
    assert parts == [{"attn" if j == 4 else "mamba", "moe" if j % 2 else
                      "mlp"} for j in range(8)]


def test_short_prompt_conv_state_is_zero_padded():
    """A prompt shorter than d_conv - 1 leaves zeros before its first
    token in the conv state, so prefill + decode equals the longer prefill
    (the reference slices fewer rows and its decode cannot take them:
    ROADMAP C11)."""
    _, cfg = _cfgs(JAMBA, "float32")
    model = tm.init_params(cfg, device="cpu")
    toks = torch.tensor([[7, 9, 11]])
    full, _ = tm.prefill(cfg, model, {"tokens": toks})
    logits, c1 = tm.prefill(cfg, model, {"tokens": toks[:, :1]})
    assert c1["layers"][0]["conv"].shape == (1, 3, 2 * cfg.d_model)
    assert not c1["layers"][0]["conv"][:, :2].any()
    cache = tm.init_cache(cfg, 1, 8, device="cpu")
    for big, small in zip(cache["layers"], c1["layers"]):
        for name, t in small.items():
            if name in ("k", "v"):
                big[name][:, :, :1] = t
            else:
                big[name][:] = t
    cache["len"][:] = 1
    for tok in (9, 11):
        logits, cache = tm.decode_step(cfg, model, cache,
                                       torch.tensor([[tok]]))
    np.testing.assert_allclose(_np(logits), _np(full), atol=1e-4, rtol=1e-4)


def test_jamba_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    tiny = tcatalog.tiny(tbase.get_config(JAMBA))
    for call in (lambda: tm.init_params(tiny),
                 lambda: tm.init_cache(tiny, 1, 8),
                 lambda: tserve.main(["--arch", JAMBA, "--tiny",
                                      "--requests", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------
SLOTS, MAX_SEQ, MAX_NEW, N_REQ = 3, 32, 6, 8


@pytest.fixture(scope="module")
def tiny_jamba():
    jcfg, tcfg = _cfgs(JAMBA, "float32")
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
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
def test_engine_and_batcher_match_jax(tiny_jamba, policy):
    jcfg, tcfg, params, np_params, jitted = tiny_jamba
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
    # the caches agree after the drain, the idle slots' included
    _close_cache(teng.cache, jax.tree.map(np.asarray, jeng.cache), tcfg,
                 1e-4, "drained engine")


def test_insert_copies_every_state_into_its_slot(tiny_jamba):
    _, tcfg, _, np_params, _ = tiny_jamba
    eng = DecodeEngine(tcfg, convert.params_from_numpy(tcfg, np_params,
                                                        "cpu"),
                       max_slots=3, max_seq=16, device="cpu")
    tok, cache1 = eng.prefill([5, 6, 7, 8, 9])
    eng.insert(1, cache1, 5, tok, Request(0, [5, 6, 7, 8, 9], 2))
    for big, small in zip(eng.cache["layers"], cache1["layers"]):
        assert big.keys() == small.keys()
        for name in small:
            if name in ("k", "v"):
                assert torch.equal(big[name][1, :, :5], small[name][0])
                assert not big[name][1, :, 5:].any()
            else:
                assert big[name].dtype == small[name].dtype
                assert torch.equal(big[name][1], small[name][0])
            assert not big[name][0].any() and not big[name][2].any()
    assert eng.cache["len"].tolist() == [0, 5, 0]


@pytest.mark.parametrize("arch", (JAMBA,) + MOE_ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    s = tserve.main(["--arch", arch, "--tiny", "--device", "cpu",
                     "--requests", "5", "--slots", "2", "--max-new", "4"])
    assert s["completed"] == 5
    out = capsys.readouterr().out
    assert "served 5 requests / 20 tokens" in out
