"""Mixture-of-Experts FFN: the dense path and the expert-parallel paths.

The port of ``repro/models/moe.py``.  Three paths, one semantics (top-k
routing with renormalized gates, :func:`route`; capacity dropping on the
EP path):

* :func:`moe_dense` — every expert applied to every token, combined with
  the gate matrix, no dropping.  Without a mesh the reference's prefill and
  decode both take it, and so do the port's: decode reads every expert's
  weights.  Under a mesh it computes the rank's experts (and its block of
  their hidden dim where ``ffn`` splits it) on the replicated tokens with
  the gates restricted to them, and sums over the axes: the mesh half of
  the reference's ``moe_decode``, and its dense fallback.
* :func:`moe_ep` — training / prefill over a mesh whose ``model`` axis
  splits the experts: tokens split over (data-parallel axes, model); a
  sort-based capacity dispatch into an (E, C, D) buffer, overflow dropped
  (:func:`_dispatch_local`); ``all_to_all`` over ``model``; grouped expert
  matmuls (:func:`_expert_ffn`) with the expert weights gathered over the
  FSDP axes; ``all_to_all`` back; scatter-add combine.
* :func:`moe_decode` — decode: one token a sequence, tokens replicated over
  ``model``; :func:`moe_dense`'s local experts and a sum.

The expert products are plain batched matmuls, as the reference leaves
them to XLA outside any Pallas kernel.  Training adds the Switch-style
load-balancing loss (:func:`aux_loss`), its statistics summed over the
ranks whose tokens differ.

A shared expert's weights sit in the layer's flat parameter dict as
``shared_w_gate`` / ``shared_w_in`` / ``shared_w_out`` (the reference's
``shared`` sub-dict).
"""

from __future__ import annotations

import math

import torch
from torch.autograd import Function

from repro_torch.configs.base import MoEConfig
from repro_torch.sharding import comm
from repro_torch.sharding import specs as sh

from .layers import act_fn, fan_in_init, init_mlp, mlp

SHARED = "shared_"
EP_AXIS = "model"


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


def aux_loss(mcfg: MoEConfig, probs, eidx, axes: tuple = ()):
    """Switch-style load-balancing loss ``E * sum_e f_e * P_e``: f_e the
    fraction of routed assignments to expert e, P_e its mean router
    probability (the gradient flows through P alone).  Under a mesh
    ``axes`` sums the statistics over the ranks whose tokens differ, so
    that the loss is the global one."""
    E = probs.shape[-1]
    onehot = torch.nn.functional.one_hot(eidx, E).float()     # (T, k, E)
    f = onehot.sum(dim=1).mean(dim=0)
    p = probs.mean(dim=0)
    if comm.active() and axes:
        cnt = comm.axes_size(axes)
        f = comm.all_reduce_raw(f, axes) / cnt
        p = comm.reduce(p, axes) / cnt
    return E * torch.sum(f * p)


def _shared(mcfg: MoEConfig, params, x, act, out):
    if not mcfg.shared_d_ff:
        return out
    shared = {k[len(SHARED):]: v for k, v in params.items()
              if k.startswith(SHARED)}
    return out + mlp(shared, x, act)


def moe_dense(mcfg: MoEConfig, params, x, act: str, with_aux: bool = False):
    """x: (B, S, D) -> (B, S, D), and with ``with_aux`` the load-balancing
    loss beside it (training).  Computes every expert on every token; under
    a mesh the rank's experts (and hidden block), summed over the axes
    that split them."""
    B, S, D = x.shape
    tokens = x.reshape(B * S, D)
    gates, eidx, probs = route(mcfg, comm.weight(params["router"]), tokens)
    gate_mat = torch.zeros((B * S, mcfg.num_experts), dtype=torch.float32,
                           device=x.device).scatter(1, eidx, gates)
    experts = comm.split_axes(params["w_gate"], 0)
    ffn = comm.split_axes(params["w_gate"], 2)
    tokens = comm.copy(tokens, experts + ffn)
    gate_mat = comm.copy(comm.split(gate_mat, 1, experts), ffn)

    h = tokens @ comm.weight(params["w_gate"])                # (E, T, F)
    u = tokens @ comm.weight(params["w_in"])
    y = (act_fn(act)(h) * u) @ comm.weight(params["w_out"])   # (E, T, D)
    out = torch.einsum("etd,te->td", y.float(), gate_mat)
    out = comm.reduce(out, experts + ffn)
    out = _shared(mcfg, params, x, act, out.reshape(B, S, D).to(x.dtype))
    if with_aux:
        return out, aux_loss(mcfg, probs, eidx, comm.batch_reduce())
    return out


# --------------------------------------------------------------------------
# Expert-parallel path (training / prefill)
# --------------------------------------------------------------------------
def _dispatch_local(mcfg: MoEConfig, tokens, gates, eidx, capacity):
    """Sort-based capacity dispatch on one rank.

    Returns (send_buf (E, C, D), slot, gate_flat, keep, tok_flat) where
    ``slot[t*k + j]`` is the flat (E*C) slot of assignment j of token t,
    or E*C where it overflowed its expert's capacity (``keep`` false)."""
    T, D = tokens.shape
    K, E, C = mcfg.top_k, mcfg.num_experts, capacity
    dev = tokens.device
    eid_flat = eidx.reshape(T * K)
    gate_flat = gates.reshape(T * K)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(K)

    order = torch.argsort(eid_flat, stable=True)
    sorted_eid = eid_flat[order]
    # rank of each assignment within its expert segment
    seg_start = torch.searchsorted(sorted_eid, torch.arange(
        E, device=dev, dtype=sorted_eid.dtype), side="left")
    rank = torch.arange(T * K, device=dev) - seg_start[sorted_eid]
    keep_sorted = rank < C
    # overflow assignments land in a spare row that is dropped, so they
    # never clobber a kept slot
    slot_sorted = torch.where(keep_sorted, sorted_eid * C + rank, E * C)
    send = torch.zeros((E * C + 1, D), dtype=tokens.dtype, device=dev)
    send = send.index_put((slot_sorted,), tokens[tok_flat[order]])[:E * C]

    # un-sort the bookkeeping so the combine indexes align with (t, j)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    return (send.reshape(E, C, D), slot_sorted[inv], gate_flat,
            keep_sorted[inv], tok_flat)


def _expert_ffn(w_gate, w_in, w_out, xs, act: str):
    """xs: (E_loc, C', D) grouped matmuls."""
    h = xs @ w_gate
    u = xs @ w_in
    return (act_fn(act)(h) * u) @ w_out


class _ScaleGrad(Function):
    @staticmethod
    def forward(ctx, w, scale):
        ctx.scale = scale
        return w

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def capacity_of(mcfg: MoEConfig, t_loc: int) -> int:
    """Slots per expert from the rank's token count: rounded up to a
    multiple of 8, at least 8."""
    capacity = int(math.ceil(t_loc * mcfg.top_k / mcfg.num_experts
                             * mcfg.capacity_factor))
    return max(8, -(-capacity // 8) * 8)


def moe_ep(mcfg: MoEConfig, params, x, act: str, with_aux: bool = True):
    """Expert-parallel MoE over the active mesh.  x: (B_loc, S, D), this
    rank's rows of the batch (split over the data-parallel axes,
    replicated over ``model``).  Returns (out, aux)."""
    mesh = sh.current_mesh()
    ep = mesh.shape[EP_AXIS]
    dp_axes = tuple(a for a in mesh.axis_names if a != EP_AXIS)
    E = mcfg.num_experts
    assert E % ep == 0, f"experts {E} not divisible by ep={ep}"
    if comm.batch_split() != dp_axes:     # unshardable batch: dense
        return moe_dense(mcfg, params, x, act, with_aux)
    if comm.split_axes(params["w_gate"], 0) != (EP_AXIS,):
        raise NotImplementedError(
            f"moe_ep needs the experts split over {EP_AXIS!r} alone, not "
            f"{comm.split_axes(params['w_gate'], 0)}")
    Bl, S, D = x.shape
    # capacity is computed from the rank's token count
    seq_shard = ep if S % ep == 0 else 1
    capacity = capacity_of(mcfg, Bl * (S // seq_shard))
    ep_axes = (EP_AXIS,) if seq_shard > 1 else ()
    E_loc = E // ep

    xl = comm.split(x, 1, ep_axes)
    tokens = xl.reshape(-1, D)
    # the tokens differ over model: the router's gradient sums over it
    router = comm.copy(comm.weight(params["router"]), ep_axes)
    w = [comm.weight(params[k]) for k in ("w_gate", "w_in", "w_out")]
    if seq_shard == 1 and ep > 1:
        # every rank of model sends the same tokens: each expert sees them
        # ep times, so its weights' gradient is scaled back
        w = [_ScaleGrad.apply(t, 1.0 / ep) for t in w]

    gates, eidx, probs = route(mcfg, router, tokens)
    send, slot, gate_flat, keep, tok_flat = _dispatch_local(
        mcfg, tokens, gates, eidx, capacity)
    # (E, C, D) = (ep, E_loc, C, D): block j goes to coordinate j of model;
    # the blocks that come back are the source ranks'
    recv = comm.all_to_all(send.reshape(ep * E_loc * capacity, D), EP_AXIS)
    xs = recv.reshape(ep, E_loc, capacity, D).transpose(0, 1).reshape(
        E_loc, ep * capacity, D)
    ys = _expert_ffn(*w, xs, act)
    back = ys.reshape(E_loc, ep, capacity, D).transpose(0, 1).reshape(
        ep * E_loc * capacity, D)
    got = comm.all_to_all(back, EP_AXIS)                      # (E*C, D)

    wgt = (gate_flat * keep.float())[:, None]
    contrib = got[slot.clamp(max=E * capacity - 1)].float() * wgt
    out = torch.zeros((tokens.shape[0], D), dtype=torch.float32,
                      device=x.device).index_add(0, tok_flat, contrib)
    out = comm.gather(out.to(x.dtype).reshape(xl.shape), 1, ep_axes)
    aux = (aux_loss(mcfg, probs, eidx, comm.batch_reduce() + ep_axes)
           if with_aux else torch.zeros((), device=x.device))
    return _shared(mcfg, params, x, act, out), aux


def moe_decode(mcfg: MoEConfig, params, x, act: str):
    """Decode: tokens replicated over ``model``; under a mesh each rank
    computes its experts' masked contribution and a sum over the axis
    combines (:func:`moe_dense`)."""
    return moe_dense(mcfg, params, x, act)


def moe_forward(mcfg: MoEConfig, params, x, act: str, mode: str = "train",
                with_aux: bool = True):
    """mode: train | prefill | decode -> (out, aux or None).  The EP path
    where a mesh's ``model`` axis (of more than one rank) divides the
    experts."""
    mesh = sh.current_mesh()
    ep_ok = (mesh is not None and EP_AXIS in mesh.axis_names
             and mcfg.num_experts % mesh.shape[EP_AXIS] == 0
             and mesh.shape[EP_AXIS] > 1)
    if mode == "decode":
        return moe_decode(mcfg, params, x, act), None
    if ep_ok:
        return moe_ep(mcfg, params, x, act, with_aux)
    if with_aux:
        return moe_dense(mcfg, params, x, act, with_aux=True)
    return moe_dense(mcfg, params, x, act), None
