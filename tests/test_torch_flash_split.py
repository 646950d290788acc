"""K5's tensor-core path on the CPU: the evidence for its P precision, the
rule that picks its path, and the contract of its source.

The tensor-core kernel (``csrc/flash_attention_sm90.cu``) multiplies the
softmax weights P by V on ``wgmma``, whose A operand is bf16.  The plain
version multiplies f32 P by V.  A plain-torch emulation of the kernel's
arithmetic (block-wise running max over 64-key blocks, f32 S, f32 row sums,
P rounded before the product) with P as one bf16 and as a bf16 hi + lo
pair, against ``flash_attention_ref`` under the card's own measure
(``flash_attention.excess``), settles which of the two the kernel needs:
one bf16 P breaks the bf16 limit by an order of magnitude wherever a row
has more than one key, the pair holds it everywhere.  The kernel issues
the pair.  The kernel itself runs only on the card (``chip_smoke.py``).
"""

import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, lm_lib, ref
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, TC_HEAD_DIMS,
                                                 excess, tensor_core_path,
                                                 tile)

#: The matrix of ``chip_smoke.py``'s ``flash_attention_vs_plain``.
FLASH_HDS = (16, 64, 80, 128, 256)
FLASH_SEQS = (1, 77, 1024, 2048)
FLASH_GROUPS = (1, 4, 8)
MASKS = [(c, w, s) for c in (True, False) for w in (0, 64)
         for s in (0.0, 30.0)]
#: Keys per block of the tensor-core kernel.
BLOCK_K = 64


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def emulate(q, k, v, *, causal, window, softcap, scale=None):
    """The tensor-core kernel's arithmetic on the CPU, for (one bf16 P,
    a bf16 hi + lo P): S in f32 from bf16 q, k; the scale (the wrapper's
    1 / sqrt(hd) unless given), the softcap and
    the -1e30 masks; per 64-key block the running max m_b, p = exp(s - m_b)
    and its f32 row sum; p rounded, times V in f32.  The online rescaling
    by corr = exp(m_prev - m_new) is folded into one factor per block,
    exp(m_b - m_last), which is what the kernel's chain of corrs
    multiplies out to."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    g = BH // BKV
    nb = -(-Sk // BLOCK_K)
    pad = (0, 0, 0, nb * BLOCK_K - Sk)      # the kernel's zero-filled rows
    kf = torch.nn.functional.pad(k.float(), pad).repeat_interleave(g, 0)
    vf = torch.nn.functional.pad(v.float(), pad).repeat_interleave(g, 0)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.bmm(q.float(), kf.transpose(1, 2)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(nb * BLOCK_K)[None, :]
    ok = kp < Sk
    if causal:
        ok = ok & (qp >= kp)
    if window:
        ok = ok & ((qp - kp) < window)
    s = torch.where(ok, s, -1e30).view(BH, Sq, nb, BLOCK_K)
    m = torch.cummax(s.amax(-1), dim=-1).values[..., None]
    p = torch.exp(s - m)
    c = torch.exp(m - m[:, :, -1:])
    den = (p.sum(-1, keepdim=True) * c).sum((2, 3))[..., None]
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    one = torch.bmm((hi * c).view(BH, Sq, -1), vf)
    two = one + torch.bmm((lo * c).view(BH, Sq, -1), vf)
    return tuple((o / den.clamp_min(1e-30)).to(q.dtype) for o in (one, two))


@pytest.mark.parametrize("S", FLASH_SEQS)
@pytest.mark.parametrize("hd", FLASH_HDS)
def test_split_p_holds_the_bf16_limit_and_one_bf16_p_breaks_it(
        hd, S, two_threads):
    """Over the 8 mask options x GQA groups {1, 4, 8} (one KV head each):
    the hi + lo pair within the limit everywhere, one bf16 P over it
    wherever a row sees more than one key."""
    rng = np.random.default_rng(hd * 10_000 + S)
    worst_one = worst_two = 0.0
    with torch.inference_mode():
        for group in FLASH_GROUPS:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (n, S, hd), dtype=np.float32)).to(torch.bfloat16)
                for n in (group, 1, 1))
            for causal, window, softcap in MASKS:
                kw = dict(causal=causal, window=window, softcap=softcap)
                want = ref.flash_attention_ref(q, k, v, **kw)
                one, two = emulate(q, k, v, **kw)
                assert torch.isfinite(two).all()
                over = excess(two, want)
                assert over <= 1.0, (group, kw, over)
                worst_two = max(worst_two, over)
                worst_one = max(worst_one, excess(one, want))
    if S == 1:
        assert worst_one == worst_two == 0.0     # p = 1 is exact in bf16
    else:
        assert worst_one > 10.0 and worst_two < 0.6, (worst_one, worst_two)


ADMITTED_HDS = range(8, MAX_HEAD_DIM + 1, 8)


@pytest.mark.parametrize("hd", ADMITTED_HDS)
def test_path_choice(hd):
    """bf16 with hd in TC_HEAD_DIMS (64, 80, 128, 256: every bf16 attention
    layer of the catalog) takes the tensor cores; f32 of every hd and bf16
    of every other hd the wrapper admits take the SIMT kernel."""
    assert TC_HEAD_DIMS == (64, 80, 128, 256)
    assert tensor_core_path(torch.bfloat16, hd) == (hd in TC_HEAD_DIMS)
    assert not tensor_core_path(torch.float32, hd)


def test_c_entry_point_mirrors_the_path_choice():
    """``flash_attention_launch`` sends the same operands to the
    tensor-core kernel as :func:`tensor_core_path` does,
    ``flash_attention_sm90_launch`` instantiates a kernel for each, and
    :func:`tile` gives each the CTA's tile (``Tiles<HD>::BM``, ``BN``)."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    rule = re.search(r"if \(dtype == 1 && \(((?:hd == \d+(?: \|\| )?)+)\)\)"
                     r"\s*return flash_attention_sm90_launch\(", src)
    assert rule, "flash_attention_launch no longer states the rule"
    hds = tuple(int(h) for h in re.findall(r"hd == (\d+)", rule.group(1)))
    assert hds == TC_HEAD_DIMS
    sm90 = (build.CSRC / "flash_attention_sm90.cu").read_text()
    cases = tuple(int(h) for h in re.findall(
        r"case (\d+):\s*return launch<\1>\(", sm90))
    assert cases == TC_HEAD_DIMS
    bm = re.search(r"int BM = HD > (\d+) \? (\d+) : (\d+);", sm90)
    bn = re.search(r"constexpr int BN = (\d+);", sm90)
    assert bm and bn, "flash_attention_sm90.cu no longer states its tile"
    above, wide, narrow = (int(x) for x in bm.groups())
    for hd in TC_HEAD_DIMS:
        BM = wide if hd > above else narrow
        assert tile(True, hd) == (BM, int(bn.group(1))), hd
    assert lm_lib.DTYPE_CODE[torch.bfloat16] == 1


@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_hd80_padded_tile_equals_the_unpadded(causal, window, softcap,
                                               two_threads):
    """The hd-80 tile's contract: the kernel stages q, k, v in two 64-column
    boxes, columns 80-127 zero-filled by TMA, and scales by the true hd's
    1 / sqrt(80).  The emulation on operands zero-padded to 128 columns
    gives, in its first 80 columns, the unpadded emulation's output bit for
    bit (zero columns add nothing to S and contribute nothing to the
    first 80 columns of P V), and zeros in the pad."""
    rng = np.random.default_rng(80)
    S, hd, wide = 300, 80, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (n, S, hd), dtype=np.float32)).to(torch.bfloat16) for n in (8, 2, 2))
    pad = lambda t: torch.nn.functional.pad(t, (0, wide - hd))
    kw = dict(causal=causal, window=window, softcap=softcap)
    with torch.inference_mode():
        want = emulate(q, k, v, **kw)
        got = emulate(pad(q), pad(k), pad(v), scale=1.0 / math.sqrt(hd), **kw)
    for g, w in zip(got, want):
        assert g.shape == (8, S, wide)
        assert torch.equal(g[..., :hd], w)
        assert not g[..., hd:].any()


def test_tensor_core_source_contract():
    """The tensor-core kernel's ``__global__`` name carries
    ``flash_attention_kernel`` (the profiler attributes its time to K5 by
    that name); its products are ``wgmma`` fed by TMA; it loads its tensor
    maps' encoder through the runtime, so that the library links against
    cudart alone."""
    src = (build.CSRC / "flash_attention_sm90.cu").read_text()
    assert re.search(r"__global__ void (__launch_bounds__\([^)]*\)\s*)?"
                     r"flash_attention_kernel_sm90\(", src)
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src
    assert "cudaGetDriverEntryPoint" in src
    assert not any("-lcuda" in f for f in lm_lib.NVCC_FLAGS)
