"""Three steps of the port's ``repro_torch.train.make_train_step`` against
the JAX package's on the CPU, f32, tiny configs, from JAX's initial state
carried over (``repro_torch.models.convert``) and the same batches (numpy,
seeded), for AdamW, Adafactor (factored; unfactored with master weights)
and SGD, with grad_accum 1 and 2.

Every parameter lies within 2e-5 * max(1, max|JAX's|) after the three steps
(2e-4 with a bf16 accumulation buffer, whose rounding of a summed gradient
is 2^-8 relative), and the loss, grad_norm and lr of each step within 1e-5
relative.  AdamW's update of an element is about the sign of its gradient:
where that gradient is near zero (at most 1e-4 of its leaf's largest in
some step, by JAX's own gradients of the step,
``repro.train.train_step._grads_plain``) a rounding can move the update by
up to its whole size, so those elements are held to 3 * the sum of the
steps' learning rates instead, and must be at most 2 % of all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as jt
from repro.train import train_step as jts
from repro_torch import train as tt
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.models import convert
from test_torch_train import _batch, _cfgs, _flat

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# Train steps
# --------------------------------------------------------------------------
STEP_CASES = [
    ("adamw", 1, {}), ("adamw", 2, {}),
    ("adafactor", 1, {}), ("adafactor", 2, {"accum_dtype": "bfloat16"}),
    ("adafactor", 1, {"factored": False, "master_weights": True}),
    ("sgd", 1, {}), ("sgd", 2, {}),
]


def _tcfgs(opt, accum, kw):
    kw = dict(optimizer=opt, grad_accum=accum, warmup_steps=2,
              learning_rate=1e-2, **kw)
    return jt.TrainConfig(**kw), tt.TrainConfig(**kw)


@pytest.mark.parametrize("opt,accum,kw", STEP_CASES, ids=str)
def test_three_train_steps_match_jax(opt, accum, kw):
    arch = "granite-moe-1b-a400m" if kw.get("master_weights") \
        else "llama3.2-1b"
    jcfg, tcfg = _cfgs(arch)
    jtc, ttc = _tcfgs(opt, accum, kw)
    js = jt.init_state(jcfg, jtc, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, js["params"])
    ts = tt.state_of(tcfg, ttc, convert.params_from_numpy(tcfg, params,
                                                          "cpu"))
    jstep = jax.jit(jt.make_train_step(jcfg, jtc))
    jgrads = jax.jit(lambda p, b: jts._grads_plain(jcfg, p, b, accum)[2])
    tstep = tt.make_train_step(tcfg, ttc)
    small = {}
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(4, 16, seed=i)
        jb = jax.tree.map(jnp.asarray, batch)
        if opt == "adamw":
            for k, g in _flat(jgrads(js["params"], jb)).items():
                near = np.abs(g) <= 1e-4 * np.abs(g).max()
                small[k] = small.get(k, False) | near
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, batch)
        lr_sum += float(jmet["lr"])
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= \
                1e-5 * abs(float(jmet[k])), (i, k)
    assert int(ts["step"]) == 3 and int(ts["opt"]["count"]) == 3
    want = _flat(js["params"])
    n_small = n_all = 0
    for k, leaf in convert.param_leaves(tcfg, ts["params"]).items():
        got = convert.stack_leaf(leaf).numpy()
        d = np.abs(got - want[k])
        tol = 2e-4 if kw.get("accum_dtype") == "bfloat16" else 2e-5
        lim = tol * max(1.0, float(np.abs(want[k]).max()))
        near = small.get(k, np.zeros(d.shape, bool))
        assert float(d[~near].max(initial=0.0)) <= lim, k
        assert float(d[near].max(initial=0.0)) <= 3 * lr_sum + lim, k
        n_small, n_all = n_small + int(near.sum()), n_all + d.size
    assert n_small <= 0.02 * n_all


def test_optimizer_state_has_the_reference_leaves():
    """The optimizer's state over the port's leaves has the reference's
    shapes, leaf for leaf (a stacked leaf over its periods)."""
    jcfg, tcfg = _cfgs("jamba-1.5-large-398b")
    for opt in ("adamw", "adafactor"):
        jtc, ttc = _tcfgs(opt, 1, {})
        jst = jax.eval_shape(lambda k: jt.init_state(jcfg, jtc, k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
        tst = tt.init_state(tcfg, ttc, torch.Generator().manual_seed(0),
                            "cpu")
        want = {k: tuple(v.shape) for k, v in _flatten_with_paths(
            jst["opt"])}
        got = {k: tuple(v.shape) for k, v in _flatten_with_paths(
            tst["opt"])}
        assert got == want, opt
        assert all(p.requires_grad for p in tst["params"].parameters())


def test_split_microbatches_refuses_an_uneven_split():
    _, tcfg = _cfgs("llama3.2-1b")
    step = tt.make_train_step(tcfg, tt.TrainConfig(grad_accum=3))
    state = tt.init_state(tcfg, tt.TrainConfig(),
                          torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="grad_accum=3"):
        step(state, _batch(4, 8))


def test_int8_dp_compression_needs_a_pod_mesh():
    """``init_state`` gives the reference's error feedback ``ef`` (f32
    zeros of every leaf's shape); the step raises without a pod mesh."""
    jcfg, tcfg = _cfgs("llama3.2-1b")
    jtc = jt.TrainConfig(dp_compression="int8")
    tc = tt.TrainConfig(dp_compression="int8")
    jst = jax.eval_shape(lambda k: jt.init_state(jcfg, jtc, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    state = tt.init_state(tcfg, tc, torch.Generator().manual_seed(0), "cpu")
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flatten_with_paths(jst["ef"])}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flatten_with_paths(state["ef"])}
    assert got == want
    assert all(not v.any() for v in state["ef"].values())
    with pytest.raises(ValueError, match="'pod' mesh axis"):
        tt.make_train_step(tcfg, tc)(state, _batch(4, 8))


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 5000, 10_000, 20_000])
def test_lr_schedule_matches_jax(step):
    kw = dict(learning_rate=3e-4, warmup_steps=100, decay_steps=10_000)
    want = float(jt.lr_schedule(jt.TrainConfig(**kw), step))
    got = float(tt.lr_schedule(tt.TrainConfig(**kw), step))
    assert abs(got - want) <= 1e-7 * want
