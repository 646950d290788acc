"""Dispatch wrapper: model-layout attention tensors -> K5's layout.

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

