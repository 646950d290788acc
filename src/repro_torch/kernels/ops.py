"""Dispatch wrappers: model-layout tensors -> the kernels' layouts (K5
attention, K6 the RWKV6 WKV scan, K7 the Mamba selective scan).

The port of ``repro/kernels/ops.py``.  The reference picks Pallas or its
plain version by backend and an environment variable (``use_pallas()``);
here the tensor's device decides, inside each kernel's wrapper: a CUDA
tensor launches the hand-written kernel, a CPU tensor runs the plain
version.  Nothing reads the environment.  RMSNorm needs no layout
mapping: :func:`repro_torch.models.layers.rmsnorm` calls K8's wrapper
(:func:`repro_torch.kernels.rmsnorm.rmsnorm`) itself.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .rwkv6_scan import rwkv6_scan


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Model layout q (B, Sq, H, hd), k / v (B, Sk, KV, hd) -> (B, Sq, H, hd)
    through K5's layout (B*H, Sq, hd) / (B*KV, Sk, hd)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qk = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kk = k.transpose(1, 2).reshape(B * KV, Sk, hd).contiguous()
    vk = v.transpose(1, 2).reshape(B * KV, Sk, hd).contiguous()
    o = flash_attention(qk, kk, vk, causal=causal, window=int(window),
                        softcap=softcap)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)


def wkv(r, k, v, w, u, head_dim: int, s0=None):
    """Model layout r / k / v / w (B, T, D) with H = D // head_dim heads,
    u (D,), s0 (B, H, n, n) or None -> (y (B, T, D) f32, S_T (B, H, n, n)
    f32) through K6's layout (B*H, T, n), u broadcast to (B*H, n)."""
    B, T, D = r.shape
    n = head_dim
    H = D // n

    def to_bh(x):
        return x.reshape(B, T, H, n).transpose(1, 2).reshape(
            B * H, T, n).contiguous()

    rb, kb, vb, wb = map(to_bh, (r, k, v, w))
    ub = u.reshape(H, n).expand(B, H, n).reshape(B * H, n).contiguous()
    s0b = None if s0 is None else s0.reshape(B * H, n, n).contiguous()
    y, sT = rwkv6_scan(rb, kb, vb, wb, ub, s0b)
    y = y.reshape(B, H, T, n).transpose(1, 2).reshape(B, T, D)
    return y, sT.reshape(B, H, n, n)


def selective_scan(dt, x, Bm, Cm, a):
    """Model layout dt / x (B, T, d_in), Bm / Cm (B, T, N), a (d_in, N) is
    K7's own -> (y (B, T, d_in) f32, the final state (B, d_in, N) f32): the
    prefill's decode cache takes the state from the same pass."""
    return mamba_scan(dt, x, Bm, Cm, a)
