"""The port's training path (``repro_torch.models.loss_fn``, the
optimizers, ``repro_torch.train.make_train_step``) against the JAX
package's on the CPU, f32, tiny configs, JAX's parameters carried over with
``repro_torch.models.convert.params_from_numpy`` and the same batches
(numpy, seeded) fed to both.

* ``loss_fn`` and its gradients for every decoder-only arch (whisper's
  are in ``test_torch_encdec.py``): loss within 1e-5 relative, every
  gradient leaf within 1e-4 * max(1, max|JAX's|).  The MoE archs carry the
  aux loss; gemma3's tiny window schedule (8) is shorter than the 16-token
  sequence; rwkv6's time-mix groupnorm weight is drawn from the seed (at the
  reference's init it is zero and no gradient would reach the scan); one
  llama case runs the chunked CE under remat and a mask.
* The shape stand-ins of ``configs/inputs.py``.

Tiny jamba is cut to its first period (8 of its 16 layers: every layer
kind of its pattern, MoE included), which halves the reference's op-by-op
gradient.  Three steps of the train step are in
``test_torch_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import base as jbase
from repro.configs import catalog as jcatalog
from repro.configs import inputs as jinputs
from repro_torch import models as tm
from repro_torch import train as tt
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.configs import base as tbase
from repro_torch.configs import catalog as tcatalog
from repro_torch.configs import inputs as tinputs
from repro_torch.models import convert
from repro_torch.train.train_step import _grads_plain

torch.set_num_threads(1)

ARCHS = [a for a in jbase.list_archs()
         if not jbase.get_config(a).is_encoder_decoder]


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", param_dtype="float32", **kw)
    j = jcatalog.tiny(jbase.get_config(arch))
    if j.num_periods > 1 and j.layers_per_period > 2:
        kw["num_layers"] = j.layers_per_period     # tiny jamba: one period
    return (j.replace(**kw), tcatalog.tiny(tbase.get_config(arch)).replace(
        **kw))


def _jax_params(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jm.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    if jcfg.rwkv6 is not None:          # make the scan reach the loss
        rng = np.random.default_rng(seed)
        for st in params["stack"]:
            if "rwkv" in st:
                st["rwkv"]["ln_w"] = rng.standard_normal(
                    st["rwkv"]["ln_w"].shape).astype(np.float32)
    return params


def _batch(B, S, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if mask:
        b["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


def _flat(tree):
    return dict(_flatten_with_paths(jax.tree.map(np.asarray, tree)))


def _port_grads(tcfg, model, batch):
    """(loss, metrics, gradients by the reference's leaf paths)."""
    return _grads_plain(tcfg, model, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})


LOSS_CASES = [(a, {}, False) for a in ARCHS] + [
    ("llama3.2-1b", {"remat": "full", "logit_chunk": 8}, True),
    ("gemma3-4b", {"remat": "dots", "logit_chunk": 4}, False),
]


@pytest.mark.parametrize("arch,kw,mask", LOSS_CASES, ids=str)
def test_loss_and_grads_match_jax(arch, kw, mask):
    jcfg, tcfg = _cfgs(arch, **kw)
    params = _jax_params(jcfg)
    batch = _batch(2, 16, mask=mask)
    (jl, jmet), jg = jax.value_and_grad(      # op by op: no compile
        lambda p, b: jm.loss_fn(jcfg, p, b), has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    model = convert.params_from_numpy(tcfg, params, "cpu")
    model.requires_grad_(True)
    tl, tmet, tg = _port_grads(tcfg, model, batch)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("ce", "aux"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            1e-5 * max(1.0, abs(float(jmet[k]))), k
    if jcfg.moe is not None:
        assert float(tmet["aux"]) > 0.5
    want = _flat(jg)
    assert set(tg) == set(want)
    for k, g in tg.items():
        lim = 1e-4 * max(1.0, float(np.abs(want[k]).max()))
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= lim, f"{k}: max|d| {err} over {lim}"


def test_rwkv6_scan_and_moe_router_get_gradients():
    """The gradient reaches the parameters behind K6 and the router."""
    for arch, key in (("rwkv6-1.6b", "stack/0/rwkv/w0"),
                      ("granite-moe-1b-a400m", "stack/0/moe/router")):
        jcfg, tcfg = _cfgs(arch)
        model = convert.params_from_numpy(tcfg, _jax_params(jcfg), "cpu")
        model.requires_grad_(True)
        _, _, g = _port_grads(tcfg, model, _batch(2, 16))
        assert float(g[key].abs().max()) > 0, key


def test_eval_step_matches_the_loss_and_keeps_no_graph():
    jcfg, tcfg = _cfgs("llama3.2-1b")
    model = convert.params_from_numpy(tcfg, _jax_params(jcfg), "cpu")
    model.requires_grad_(True)
    batch = _batch(2, 8)
    out = tt.make_eval_step(tcfg)(model, batch)
    loss, _ = jm.loss_fn(jcfg, _jax_params(jcfg),
                         jax.tree.map(jnp.asarray, batch))
    assert out["loss"].grad_fn is None
    assert abs(float(out["loss"]) - float(loss)) <= 1e-5 * float(loss)


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-large-v3"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_input_specs_match_the_reference(arch, shape):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    want = jinputs.input_specs(jcfg, jbase.SHAPES[shape])
    got = tinputs.input_specs(tcfg, tbase.SHAPES[shape])
    assert len(got) == len(want) == 1
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want[0].items()} \
        == {k: (s, str(d).removeprefix("torch.")) for k, (s, d)
            in got[0].items()}


def test_decode_inputs_match_the_port_cache():
    cfg = tcatalog.tiny(tbase.get_config("jamba-1.5-large-398b"))
    cache, tokens = tinputs.decode_inputs(cfg, tbase.ShapeConfig(
        "d", 32, 2, "decode"))
    real = tm.init_cache(cfg, 2, 32, device="cpu")
    assert tokens == ((2, 1), torch.int32)
    assert cache["len"] == ((2,), torch.int32)
    for spec, entry in zip(cache["layers"], real["layers"]):
        assert spec == {k: (tuple(v.shape), v.dtype)
                        for k, v in entry.items()}


def test_concrete_batch_shapes_and_labels():
    cfg = tcatalog.tiny(tbase.get_config("llama3.2-1b"))
    b = tinputs.concrete_batch(cfg, 3, 7, torch.Generator().manual_seed(0))
    assert b["tokens"].shape == (3, 7) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, 1))
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 256
