"""Config schema for every architecture the framework can instantiate.

The PyTorch port's own copy of ``repro/configs/base.py`` (framework-free;
the port imports nothing of ``repro``): a :class:`ModelConfig` fully
determines a model, its decoder (or enc-dec) stack assembled from per-layer
*mixer* (attention / mamba / rwkv6) and *ffn* (dense / moe) choices.  The
two copies are held field for field by ``tests/test_torch_models.py``.

Shapes (assignment grid):

    train_4k      seq_len=4096    global_batch=256   -> train_step
    prefill_32k   seq_len=32768   global_batch=32    -> prefill_step
    decode_32k    seq_len=32768   global_batch=128   -> serve_step (1 new tok)
    long_500k     seq_len=524288  global_batch=1     -> serve_step; only for
                                                        sub-quadratic archs
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

MixerKind = Literal["attention", "mamba", "rwkv6", "none"]
FFNKind = Literal["dense", "moe", "rwkv_ffn"]


# --------------------------------------------------------------------------
# Per-layer building blocks
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    # sliding-window size; 0 = full (global) attention
    window: int = 0
    qkv_bias: bool = False
    out_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # gemma-style soft logit cap (0 = off)
    logit_softcap: float = 0.0
    # qk normalization (gemma3 / qwen3 style)
    qk_norm: bool = False
    causal: bool = True


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKV6Config:
    head_dim: int = 64
    lora_w: int = 64            # decay lora rank (token-shift ddlerp)
    lora_mix: int = 32


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # shared dense expert in parallel with routed experts (granite style: none)
    shared_d_ff: int = 0
    router_logit_softcap: float = 0.0


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the stack: a mixer + an ffn, pre-norm residual."""

    mixer: MixerKind = "attention"
    ffn: FFNKind = "dense"


# --------------------------------------------------------------------------
# Whole-model config
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    d_ff: int                    # dense-FFN hidden dim
    vocab_size: int

    attention: AttentionConfig | None = None
    mamba: MambaConfig | None = None
    rwkv6: RWKV6Config | None = None
    moe: MoEConfig | None = None

    # Homogeneous stack: layer_period == 1 and pattern == (LayerSpec(...),).
    # Heterogeneous (jamba): pattern length P; stack = P * (num_layers // P).
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    # per-layer attention window schedule for homogeneous stacks, as a
    # repeating pattern over layer index (gemma3: 5 local + 1 global).
    # None -> every attention layer uses attention.window.
    window_pattern: tuple[int, ...] | None = None
    # per-layer rope theta pattern, aligned with window_pattern (gemma3 uses
    # 10k for local layers and 1M for global layers).
    rope_theta_pattern: tuple[float, ...] | None = None

    # enc-dec (whisper): encoder stack config; decoder = the main stack with
    # cross-attention interleaved.
    encoder_layers: int = 0
    encoder_seq: int = 1500      # whisper: fixed 1500 frames post-conv
    is_encoder_decoder: bool = False

    # embeddings / head
    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma multiplies embeddings by sqrt(d_model)
    norm_eps: float = 1e-6
    act: str = "silu"            # silu | gelu | relu_sq
    use_abs_pos: bool = False    # learned/sinusoidal absolute positions

    # numerics
    dtype: str = "bfloat16"      # activation/param compute dtype
    param_dtype: str = "bfloat16"
    logit_chunk: int = 512       # seq-chunked vocab loss (0 = unchunked)
    remat: str = "full"          # activation checkpointing: none|full|dots

    # modality frontend stub: inputs arrive as precomputed embeddings
    # ("tokens" for LM; "frames" for audio; "mixed" vlm = tokens incl. VQ ids)
    input_kind: str = "tokens"

    # ---- derived -----------------------------------------------------------
    @property
    def layers_per_period(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.layers_per_period == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by "
            f"period {self.layers_per_period}")
        return self.num_layers // self.layers_per_period

    def num_params(self) -> int:
        """Closed-form parameter count (embeddings + stack), for rooflines."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for i in range(self.num_layers):
            spec = self.pattern[i % self.layers_per_period]
            n += self._mixer_params(spec.mixer) + self._ffn_params(spec.ffn)
            n += 2 * self.d_model            # two pre-norms
        n += self.d_model                    # final norm
        if self.is_encoder_decoder:
            a = self.attention
            per = (self._mixer_params("attention") + self._ffn_params("dense")
                   + 2 * self.d_model)
            n += self.encoder_layers * per
            # cross-attention in every decoder layer
            n += self.num_layers * (self._mixer_params("attention")
                                    + self.d_model)
        return n

    def active_params(self) -> int:
        """Per-token active parameters (MoE: top_k of num_experts)."""
        n = self.vocab_size * self.d_model   # logits matmul is per-token work
        for i in range(self.num_layers):
            spec = self.pattern[i % self.layers_per_period]
            n += self._mixer_params(spec.mixer)
            if spec.ffn == "moe":
                m = self.moe
                n += (3 * m.d_ff * self.d_model * m.top_k
                      + self.d_model * m.num_experts // max(1, self.d_model)
                      + (3 * m.shared_d_ff * self.d_model))
            else:
                n += self._ffn_params(spec.ffn)
        return n

    def _mixer_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "attention":
            a = self.attention
            q = d * a.num_heads * a.head_dim
            kv = 2 * d * a.num_kv_heads * a.head_dim
            o = a.num_heads * a.head_dim * d
            b = (a.num_heads + 2 * a.num_kv_heads) * a.head_dim if a.qkv_bias else 0
            return q + kv + o + b
        if kind == "mamba":
            m = self.mamba
            d_in = m.expand * d
            dt_rank = m.dt_rank or -(-d // 16)
            return (d * 2 * d_in                  # in_proj (x, z)
                    + d_in * m.d_conv + d_in      # conv
                    + d_in * (dt_rank + 2 * m.d_state)   # x -> dt,B,C
                    + dt_rank * d_in + d_in       # dt_proj
                    + d_in * m.d_state + d_in     # A_log, D
                    + d_in                        # rmsnorm gate
                    + d_in * d)                   # out_proj
        if kind == "rwkv6":
            d_in = self.d_ff and self.d_model  # r/k/v/g/o are d x d
            r = self.rwkv6
            return 4 * d * d + d * d + 2 * (r.lora_w * d + r.lora_w * d) \
                + 5 * (r.lora_mix * d * 2) + 10 * d
        if kind == "none":
            return 0
        raise ValueError(kind)

    def _ffn_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "dense":
            return 3 * d * self.d_ff
        if kind == "moe":
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_ff + d * m.num_experts
            shared = 3 * d * m.shared_d_ff if m.shared_d_ff else 0
            return routed + shared
        if kind == "rwkv_ffn":
            # rwkv6 channel-mix: k (d x 3.5d), v (3.5d x d), r (d x d)
            return d * self.d_ff + self.d_ff * d + d * d
        raise ValueError(kind)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Shape grid
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment skip rules.  Returns (run?, reason-if-skipped)."""
    if shape.name == "long_500k":
        subquadratic = cfg.family in ("ssm", "hybrid")
        if not subquadratic:
            return False, ("long_500k skipped: full-attention arch "
                           "(quadratic); run only for SSM/hybrid")
    return True, ""


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_REGISTRY: dict[str, "callable"] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    # import the per-arch modules lazily so `configs` has no import cycle
    from . import catalog  # noqa: F401  (populates _REGISTRY)
    try:
        return _REGISTRY[arch_id]()
    except KeyError as e:
        raise ValueError(
            f"unknown arch {arch_id!r}; options: {sorted(_REGISTRY)}") from e


def list_archs() -> list[str]:
    from . import catalog  # noqa: F401
    return sorted(_REGISTRY)
