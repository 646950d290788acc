"""Carrying the reference's parameters and decode caches into the port.

The reference keeps its parameters as a pytree whose layer leaves are
stacked over periods (``stack[j][part][name]`` of shape ``(num_periods,
...)`` for pattern position ``j``) and its decode cache likewise
(``{"stack": (per position: {"k", "v"} of shape (periods, B, S, KV, hd),
{"att_shift", "ffn_shift", "wkv"} or {"conv", "ssm"} of shape (periods,
B, ...)), "len": (B,)}``).  The port holds one
:class:`~repro_torch.models.transformer.Layer` per layer and one cache
entry per layer, k / v as (B, KV, S, hd), rwkv6 and mamba states as the
reference has them.  A part's sub-dict (the MoE's ``shared`` expert) is
flattened into the part as ``<sub>_<name>``.  These functions map numpy
trees (``jax.tree.map(np.asarray, tree)`` on the reference side) to and
from the port's objects; they import nothing of JAX.

Training names each parameter leaf by its path in the reference's tree
(:func:`param_leaves`: ``embed/tok``, ``final_norm``,
``stack/<j>/<part>/<name>``, ``stack/<j>/moe/shared/w_gate``), so that the
optimizer sees the reference's leaves (a stacked leaf is one tensor over
the periods, as its weight decay and Adafactor's factoring and scales
read it) and a checkpoint holds them under the reference's paths.

An encoder-decoder's tree (whisper) is ``{"embed", "encoder": {part:
{name: (encoder_layers, ...)}}, "enc_norm": {"w", "b"}, "decoder": {...},
"dec_norm"}``, its leaves ``encoder/<part>/<name>`` stacked over the
layers; its cache ``{"k", "v"}`` of shape (L, B, S, KV, hd), ``"enc_kv"``
a pair of (L, B, S_enc, KV, hd) and ``"len"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import encdec, transformer


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: no torch twin
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _numpy(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


#: The parameter groups of a layer, by the reference's names.
_PARTS = ("attn", "mamba", "rwkv", "mlp", "moe", "rwkvffn")
#: Cache entries the port keeps as (B, KV, S, hd), the reference as (B, S,
#: KV, hd); every other entry has the reference's layout.
_KV = ("k", "v")


def _swap_layout(name, t):
    """A cache entry in the other package's layout (the swap of k / v's
    axes 1 and 2 is its own inverse)."""
    return t.transpose(1, 2).contiguous() if name in _KV else t


def _layer_index(cfg: ModelConfig, l: int):
    """(pattern position, period) of layer ``l``."""
    P = cfg.layers_per_period
    return l % P, l // P


def _flat(part: dict) -> dict:
    """A part's leaves, sub-dicts flattened to ``<sub>_<name>``."""
    out = {}
    for k, v in part.items():
        if isinstance(v, dict):
            out.update({f"{k}_{n}": a for n, a in v.items()})
        else:
            out[k] = v
    return out


def _ref_name(name: str) -> str:
    """A part's flat key as the reference's path inside the part."""
    for sub in ("shared",):
        if name.startswith(sub + "_"):
            return f"{sub}/{name[len(sub) + 1:]}"
    return name


def _encdec_leaves(model) -> dict:
    out = {f"embed/{k}": v for k, v in model.embed.items()}
    for stack in ("encoder", "decoder"):
        groups: dict = {}
        for layer in getattr(model, stack):
            for part in layer.part_names:
                for k, v in getattr(layer, part).items():
                    groups.setdefault(f"{stack}/{part}/{k}", []).append(v)
        out.update({k: tuple(v) for k, v in groups.items()})
    for norm in ("enc_norm", "dec_norm"):
        out.update({f"{norm}/{k}": v
                    for k, v in getattr(model, norm).items()})
    return out


def param_leaves(cfg: ModelConfig, model) -> dict:
    """The model's parameters by the reference's leaf paths: an unstacked
    leaf (the embeddings, the final norm) maps to its parameter, a stacked
    one to the tuple of its layers' parameters in period order (the
    reference's leaf is their stack)."""
    if cfg.is_encoder_decoder:
        return _encdec_leaves(model)
    out = {f"embed/{k}": v for k, v in model.embed.items()}
    out["final_norm"] = model.final_norm
    groups: dict = {}
    for l, layer in enumerate(model.layers):
        j, _ = _layer_index(cfg, l)
        named = [("norm1", layer.norm1), ("norm2", layer.norm2)]
        for part in _PARTS:
            if hasattr(layer, part):
                named += [(f"{part}/{_ref_name(k)}", v)
                          for k, v in getattr(layer, part).items()]
        for name, t in named:
            groups.setdefault(f"stack/{j}/{name}", []).append(t)
    out.update({k: tuple(v) for k, v in groups.items()})
    return out


def stack_leaf(leaf):
    """A leaf of :func:`param_leaves` as the reference's tensor (detached;
    a stacked leaf is a copy)."""
    if isinstance(leaf, tuple):
        return torch.stack([t.detach() for t in leaf])
    return leaf.detach()


def load_leaves(cfg: ModelConfig, model, tree) -> None:
    """Copy ``tree`` (the reference's leaf paths -> numpy arrays or tensors
    of the reference's shapes, e.g. a restored checkpoint) into the model's
    parameters, in place."""
    with torch.no_grad():
        for path, leaf in param_leaves(cfg, model).items():
            src = tree[path]
            if not isinstance(src, torch.Tensor):
                src = _tensor(src, "cpu")
            if isinstance(leaf, tuple):
                for t, s in zip(leaf, src):
                    t.copy_(s)
            else:
                leaf.copy_(src)


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter pytree (numpy leaves) as the port's
    module, on ``device`` (default: the card)."""
    device = resolve_device(device)
    t = lambda a: _tensor(a, device)
    if cfg.is_encoder_decoder:
        stacks = {}
        for stack, n in (("encoder", cfg.encoder_layers),
                         ("decoder", cfg.num_layers)):
            st = tree[stack]
            stacks[stack] = [{part: {k: t(v[l]) for k, v in st[part].items()}
                              for part in st} for l in range(n)]
        norm = lambda name: {k: t(v) for k, v in tree[name].items()}
        return encdec.EncDec({k: t(v) for k, v in tree["embed"].items()},
                             stacks["encoder"], norm("enc_norm"),
                             stacks["decoder"], norm("dec_norm"))
    layers = []
    for l in range(cfg.num_layers):
        j, p = _layer_index(cfg, l)
        st = tree["stack"][j]
        parts = {name: {k: t(v[p]) for k, v in _flat(st[name]).items()}
                 for name in _PARTS if name in st}
        layers.append((t(st["norm1"][p]), t(st["norm2"][p]), parts))
    return transformer.build(
        cfg, {k: t(v) for k, v in tree["embed"].items()},
        t(tree["final_norm"]), layers)


def cache_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's decode (or prefill) cache as the port's."""
    device = resolve_device(device)
    if cfg.is_encoder_decoder:
        ek, ev = tree["enc_kv"]
        swap = lambda a, l: _swap_layout("k", _tensor(a[l], device))
        layers = [{"k": swap(tree["k"], l), "v": swap(tree["v"], l),
                   "enc_k": swap(ek, l), "enc_v": swap(ev, l)}
                  for l in range(cfg.num_layers)]
        return {"layers": layers,
                "len": _tensor(tree["len"], device, torch.int32)}
    layers = []
    for l in range(cfg.num_layers):
        j, p = _layer_index(cfg, l)
        e = tree["stack"][j]
        layers.append({n: _swap_layout(n, _tensor(a[p], device))
                       for n, a in e.items()})
    return {"layers": layers,
            "len": _tensor(tree["len"], device, torch.int32)}


def cache_to_numpy(cfg: ModelConfig, cache):
    """The port's cache in the reference's layout (numpy, f32 for bf16)."""
    if cfg.is_encoder_decoder:
        st = lambda name: np.stack([_numpy(_swap_layout("k", e[name]))
                                    for e in cache["layers"]])
        return {"k": st("k"), "v": st("v"),
                "enc_kv": (st("enc_k"), st("enc_v")),
                "len": _numpy(cache["len"])}
    P, n = cfg.layers_per_period, cfg.num_periods
    stack = []
    for j in range(P):
        entries = [cache["layers"][p * P + j] for p in range(n)]
        stack.append({name: np.stack([_numpy(_swap_layout(name, e[name]))
                                      for e in entries])
                      for name in entries[0]})
    return {"stack": tuple(stack), "len": _numpy(cache["len"])}
