"""The port's language-model kernels on the CPU: the plain versions
(``repro_torch.kernels.ref.flash_attention_ref`` / ``rmsnorm_ref``) against
the JAX package's plain versions and against its Pallas kernels run in
interpret mode, the layout wrappers of ``repro_torch.kernels.ops`` against
``repro.kernels.ops``, and the CUDA wrappers' refusals of what their kernels
do not take (driven with meta tensors).  The CUDA kernels themselves run
only on the card (``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import build, lm_lib, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import layers

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _both(a, name):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# the matrix of tests/test_kernels.py, plus the non-power-of-two hd 80
FLASH_CASES = [
    (4, 2, 256, 256, 64, True, 0, 0.0),     # GQA causal
    (4, 4, 128, 384, 64, True, 0, 0.0),     # cross-length
    (2, 1, 200, 200, 32, True, 64, 0.0),    # sliding window + padding
    (2, 2, 256, 256, 64, False, 0, 0.0),    # bidirectional (encoder)
    (4, 2, 256, 256, 128, True, 0, 30.0),   # gemma softcap
    (1, 1, 96, 512, 64, True, 128, 0.0),    # window > q extent
    (4, 1, 150, 150, 80, True, 0, 0.0),     # stablelm head dim
]


def _flash_inputs(BH, BKV, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, Sq, hd)).astype(np.float32),
            rng.standard_normal((BKV, Sk, hd)).astype(np.float32),
            rng.standard_normal((BKV, Sk, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,causal,window,softcap",
                         FLASH_CASES)
@pytest.mark.parametrize("against", ["jax_ref", "pallas"])
def test_flash_attention_ref_matches_jax(against, BH, BKV, Sq, Sk, hd,
                                         causal, window, softcap, dtype):
    arrays = _flash_inputs(BH, BKV, Sq, Sk, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.flash_attention_ref(tq, tk, tv, **kw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (BH, Sq, hd)
    if against == "jax_ref":
        want = jref.flash_attention_ref(jq, jk, jv, **kw)
    else:
        want = pallas_flash(jq, jk, jv, interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


RMS_SHAPES = [(4, 7, 128), (3, 256), (1000, 64), (7, 80)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("against", ["jax_ref", "pallas"])
def test_rmsnorm_ref_matches_jax(against, shape, dtype):
    rng = np.random.default_rng(1)
    (jx, tx) = _both(rng.standard_normal(shape).astype(np.float32), dtype)
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    got = ref.rmsnorm_ref(tx, torch.from_numpy(w))
    assert got.dtype == DTYPES[dtype][1] and got.shape == shape
    if against == "jax_ref":
        want = jref.rmsnorm_ref(jx, jnp.asarray(w))
    else:
        want = pallas_rmsnorm(jx, jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 20.0)])
def test_ops_attention_layout_matches_jax(window, softcap, dtype):
    """Model layout (B, S, H, hd) -> kernel layout and back, GQA 4:2."""
    rng = np.random.default_rng(2)
    B, S, H, KV, hd = 2, 33, 4, 2, 16
    (jq, tq) = _both(rng.standard_normal((B, S, H, hd)).astype(np.float32),
                     dtype)
    (jk, tk), (jv, tv) = (
        _both(rng.standard_normal((B, S, KV, hd)).astype(np.float32), dtype)
        for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap)
    got = ops.attention(tq, tk, tv, **kw)
    want = jops.attention(jq, jk, jv, **kw)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(4, 2, 70, 70, 24))
    before = (flash_attention.launches, rmsnorm.launches)
    assert torch.equal(flash_attention(q, k, v, window=9),
                       ref.flash_attention_ref(q, k, v, window=9))
    x, w = torch.randn(5, 3, 40), torch.randn(40)
    assert torch.equal(rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    assert torch.equal(layers.rmsnorm(x.transpose(0, 1), w),
                       ref.rmsnorm_ref(x.transpose(0, 1), w))
    assert (flash_attention.launches, rmsnorm.launches) == before


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("q,k,v,err,match", [
    (_meta(4, 8, 12), _meta(2, 8, 12), _meta(2, 8, 12), ValueError,
     "head dim hd=12"),
    (_meta(4, 8, 264), _meta(2, 8, 264), _meta(2, 8, 264), ValueError,
     "head dim hd=264"),
    (_meta(4, 8, 64), _meta(3, 8, 64), _meta(3, 8, 64), ValueError,
     "multiple of BKV"),
    (_meta(4, 8, 64), _meta(2, 8, 64), _meta(2, 9, 64), ValueError,
     "do not match"),
    (_meta(4, 8, 64, dtype=torch.float16), _meta(2, 8, 64, dtype=torch.float16),
     _meta(2, 8, 64, dtype=torch.float16), TypeError, "float32 or bfloat16"),
    (_meta(4, 8, 64), _meta(2, 8, 64, dtype=torch.float32), _meta(2, 8, 64),
     TypeError, "alike"),
    (_meta(4, 8, 64), _meta(2, 0, 64), _meta(2, 0, 64), ValueError, "Sk=0"),
    (_meta(8, 64), _meta(2, 8, 64), _meta(2, 8, 64), ValueError,
     "B\\*heads"),
    (_meta(4, 8, 80), _meta(2, 8, 80), _meta(2, 8, 80), ValueError,
     "cuda or cpu"),
])
def test_flash_attention_wrapper_refuses(q, k, v, err, match):
    before = flash_attention.launches
    with pytest.raises(err, match=match):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("x,w,err,match", [
    (_meta(4, 64, dtype=torch.float16), _meta(64), TypeError, "float32"),
    (_meta(4, 64), _meta(63), ValueError, "expected"),
    (_meta(4, 64), _meta(64, dtype=torch.float32), TypeError, "alike"),
    (_meta(4, 70), _meta(70), ValueError, "multiple of 8"),
    (_meta(4, 70, dtype=torch.float32), _meta(70, dtype=torch.float32),
     ValueError, "multiple of 4"),
    (_meta(4, 64), _meta(64), ValueError, "cuda or cpu"),
])
def test_rmsnorm_wrapper_refuses(x, w, err, match):
    with pytest.raises(err, match=match):
        rmsnorm(x, w)


def test_lm_library_sources_and_flags():
    """K5 and K8 are their own library beside the simulator's: each source
    defines the C entry point its wrapper loads; sm_90a, no fast math."""
    for name in lm_lib.SOURCES:
        src = (build.CSRC / name).read_text()
        entry = name.removesuffix(".cu") + "_launch"
        assert re.search(r'extern "C" int ' + entry + r"\(", src), name
        assert "cudaGetLastError" in src
    assert "arch=compute_90a,code=sm_90a" in lm_lib.NVCC_FLAGS
    assert not any("fast" in f for f in lm_lib.NVCC_FLAGS)
    assert lm_lib.LIBRARY.path().name.startswith("liblm_")
    assert lm_lib.LIBRARY.path().parent == build.BUILD_DIR
