"""Mixture-of-Experts FFN on one device.

The port of the one-device part of ``repro/models/moe.py``: top-k routing
with renormalized gates (:func:`route`) and the dense path
(:func:`moe_dense`), every expert applied to every token and combined with
the gate matrix, no capacity dropping.  Without a mesh the reference's
prefill and decode both take that path (``moe_forward``, ``moe_decode``),
and the port's layers call it in both: decode reads every expert's
weights.  The expert products are plain batched matmuls, as the reference
leaves them to XLA outside any Pallas kernel.  Training adds the
Switch-style load-balancing loss (:func:`aux_loss`, ``moe_dense(...,
with_aux=True)``); the expert-parallel paths (``moe_ep``, the
``shard_map`` half of ``moe_decode``) need a mesh.

A shared expert's weights sit in the layer's flat parameter dict as
``shared_w_gate`` / ``shared_w_in`` / ``shared_w_out`` (the reference's
``shared`` sub-dict).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig

from .layers import act_fn, fan_in_init, init_mlp, mlp

SHARED = "shared_"


def init_moe(gen, mcfg: MoEConfig, d_model: int, dtype, device):
    E, F = mcfg.num_experts, mcfg.d_ff
    p = {
        "router": fan_in_init(gen, (d_model, E), torch.float32, device),
        "w_gate": fan_in_init(gen, (E, d_model, F), dtype, device,
                              fan_axis=1),
        "w_in": fan_in_init(gen, (E, d_model, F), dtype, device, fan_axis=1),
        "w_out": fan_in_init(gen, (E, F, d_model), dtype, device,
                             fan_axis=1),
    }
    if mcfg.shared_d_ff:
        p.update({SHARED + k: v for k, v in init_mlp(
            gen, d_model, mcfg.shared_d_ff, dtype, device).items()})
    return p


def route(mcfg: MoEConfig, router_w, tokens):
    """tokens (T, D) -> (gates (T, k) f32, eidx (T, k) int64, probs (T, E)
    f32)."""
    logits = tokens.float() @ router_w.float()
    if mcfg.router_logit_softcap:
        logits = torch.tanh(logits / mcfg.router_logit_softcap) \
            * mcfg.router_logit_softcap
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, mcfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eidx, probs


def aux_loss(mcfg: MoEConfig, probs, eidx):
    """Switch-style load-balancing loss ``E * sum_e f_e * P_e``: f_e the
    fraction of routed assignments to expert e, P_e its mean router
    probability (the gradient flows through P alone)."""
    E = probs.shape[-1]
    onehot = torch.nn.functional.one_hot(eidx, E).float()     # (T, k, E)
    f = onehot.sum(dim=1).mean(dim=0)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def moe_dense(mcfg: MoEConfig, params, x, act: str, with_aux: bool = False):
    """x: (B, S, D) -> (B, S, D), and with ``with_aux`` the load-balancing
    loss beside it (training).  Computes every expert on every token."""
    B, S, D = x.shape
    tokens = x.reshape(B * S, D)
    gates, eidx, probs = route(mcfg, params["router"], tokens)
    gate_mat = torch.zeros((B * S, mcfg.num_experts), dtype=torch.float32,
                           device=x.device).scatter(1, eidx, gates)

    h = tokens @ params["w_gate"]                             # (E, T, F)
    u = tokens @ params["w_in"]
    y = (act_fn(act)(h) * u) @ params["w_out"]                # (E, T, D)
    out = torch.einsum("etd,te->td", y.float(), gate_mat)
    out = out.reshape(B, S, D).to(x.dtype)
    if mcfg.shared_d_ff:
        shared = {k[len(SHARED):]: v for k, v in params.items()
                  if k.startswith(SHARED)}
        out = out + mlp(shared, x, act)
    if with_aux:
        return out, aux_loss(mcfg, probs, eidx)
    return out
