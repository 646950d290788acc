"""Per-architecture parallelism profiles.

The port of ``repro/sharding/profiles.py``: the same rules, resolved to
:class:`~repro_torch.sharding.specs.MeshRules`.

* **train** — DP over (pod, data); TP over model (heads/ffn/vocab/expert);
  FSDP (ZeRO-3 weights + optimizer state) over data; for deep/wide models
  the carried residual stream is additionally sequence-sharded over model
  (``seqcarry``).  For archs whose head count does not divide the model
  axis, ``kvseq`` resolves to model instead (context-parallel K/V).
* **serve** — KV caches sequence-sharded over model (flash-decode);
  weights replicated over data, except >= 2.5 B-param models which FSDP
  their weights over data.

``overrides`` re-shards without touching code: ``--set seqcarry=model
--set fsdp=pod,data`` through :func:`parse_rule_overrides`.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .specs import MeshRules


def _axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def train_rules(cfg: ModelConfig, mesh, overrides: dict | None = None
                ) -> MeshRules:
    model_sz = _axis_size(mesh, "model")
    heads_divisible = (cfg.attention is not None
                       and cfg.attention.num_heads % model_sz == 0)
    # deep/wide models: shard the remat'd carry over model (seq dim)
    big_carry = cfg.d_model * cfg.num_layers >= 80_000
    rules = MeshRules(
        batch=("pod", "data"),
        seq=None,
        seqcarry="model" if big_carry else None,
        kvseq=None if (heads_divisible or cfg.attention is None)
        else "model",
        heads="model",
        kvheads="model",
        dmodel=None,
        ffn="model",
        vocab="model",
        expert="model",
        fsdp=("data",),
    )
    if overrides:
        rules = rules.with_overrides(**overrides)
    return rules


def serve_rules(cfg: ModelConfig, mesh, overrides: dict | None = None
                ) -> MeshRules:
    from repro_torch import models
    # >=2.5B: replicated weights crowd out the KV cache; below that the
    # per-layer gather latency isn't worth the <2 GB saved
    big = models.param_count(cfg) >= 2.5e9
    rules = MeshRules(
        batch=("pod", "data"),
        seq=None,
        seqcarry=None,
        kvseq="model",
        heads="model",
        kvheads="model",
        dmodel=None,
        ffn="model",
        vocab="model",
        expert="model",
        fsdp=("data",) if big else None,
    )
    if overrides:
        rules = rules.with_overrides(**overrides)
    return rules


def rules_for(cfg: ModelConfig, mesh, step: str,
              overrides: dict | None = None) -> MeshRules:
    if step == "train":
        return train_rules(cfg, mesh, overrides).restrict(mesh)
    return serve_rules(cfg, mesh, overrides).restrict(mesh)


def parse_rule_overrides(pairs: list[str]) -> dict:
    """['seqcarry=model', 'fsdp=pod,data', 'kvseq='] -> kwargs dict."""
    out: dict = {}
    for p in pairs:
        k, _, v = p.partition("=")
        if not v:
            out[k] = None
        elif "," in v:
            out[k] = tuple(x for x in v.split(",") if x)
        else:
            out[k] = v
    return out
