"""Model configuration: frozen dataclasses and the ``--arch`` registry.

Field names and defaults are those of ``repro.config`` (the JAX package), so
a config converts between the two field for field. ``ParallelConfig`` is
copied whole; the port reads its ``remat`` and ``grad_dtype`` and has no
device mesh yet, so its sharding fields are unused until ROADMAP Queue 1
item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.utils import round_up


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"                # "gqa" | "mla"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10000.0
    use_rope: bool = True            # whisper uses learned/sinusoidal positions
    sliding_window: int = 0          # 0 = full attention; >0 = SWA window
    # local:global interleave (gemma3): every `global_every`-th layer is
    # global, others use `local_window` sliding window. 0 disables.
    global_every: int = 0
    local_window: int = 1024
    # MLA (deepseek-v2) parameters
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    logit_softcap: float = 0.0

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.num_heads * self.head_dim

    @property
    def o_in_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * self.v_head_dim
        return self.num_heads * self.head_dim

    def layer_window(self, layer_idx: int) -> int:
        """Effective attention window for a layer. 0 means full/global."""
        if self.global_every > 0:
            is_global = (layer_idx + 1) % self.global_every == 0
            return 0 if is_global else self.local_window
        return self.sliding_window


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0             # routed experts; 0 = dense model
    num_shared_experts: int = 0
    top_k: int = 2
    expert_ff: int = 0               # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_every: int = 1               # MoE on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    first_k_dense: int = 0           # leading dense layers (deepseek-v2)
    first_dense_ff: int = 0          # d_ff of those dense layers (0 -> model d_ff)

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.num_experts == 0 or layer_idx < self.first_k_dense:
            return False
        return (layer_idx % self.moe_every) == self.moe_offset


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128             # N
    head_dim: int = 64               # P
    expand: int = 2                  # d_inner = expand * d_model
    n_groups: int = 1                # B/C groups (G)
    conv_width: int = 4
    chunk_size: int = 256            # SSD chunk length
    head_block: int = 16             # heads per plain SSD block (memory)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"            # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    d_ff: int = 512
    vocab_size: int = 1024
    max_seq_len: int = 4096
    attention: Optional[AttentionConfig] = None
    moe: MoEConfig = MoEConfig()
    ssm: Optional[SSMConfig] = None
    mlp_act: str = "silu_glu"        # silu_glu | gelu_glu | relu2 | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128
    # hybrid (jamba): within each block of `attn_every` layers, layer at index
    # `attn_index` is attention and the rest are mamba. attn_every==1 -> all attn.
    attn_every: int = 1
    attn_index: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed encoder frames (whisper: 1500)
    # modality frontend stubs supply precomputed embeddings
    frontend: str = "none"           # none | audio_stub | patch_stub
    num_patches: int = 0             # vlm: patch embeddings prepended to text
    dtype: str = "bfloat16"
    # block sizes of the JAX package's blockwise attention (kept for parity
    # of the field set; the port's kernel picks its own tiles)
    attn_block_q: int = 512
    attn_block_kv: int = 512

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    def is_attn_layer(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every <= 1:
            return True
        return (layer_idx % self.attn_every) == self.attn_index

    def validate(self) -> None:
        if self.family != "ssm" and self.attention is None:
            raise ValueError(f"{self.name}: non-ssm model needs attention config")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: ssm/hybrid model needs ssm config")
        if self.moe.num_experts and not self.moe.expert_ff:
            raise ValueError(f"{self.name}: moe needs expert_ff")
        if self.family == "audio" and self.encoder_layers <= 0:
            raise ValueError(f"{self.name}: audio model needs encoder layers")


# ---------------------------------------------------------------------------
# parallelism / run configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The JAX package's ``ParallelConfig``, field for field.

    The port reads ``remat`` (``none``; ``full`` recomputes each layer in the
    backward pass; ``dots`` does the same, see ``Model``) and ``grad_dtype``
    (``float32``: gradients of the fp32 masters; ``bfloat16``: gradients of
    a bf16 cast of them, applied to the fp32 masters). The mesh and sharding
    fields (``zero``, ``shard_model_axes``, ``sequence_parallel``,
    ``expert_parallel``, ``moe_impl``, ``decode_moe_impl``) wait for ROADMAP
    Queue 1 item 12; ``scan_layers`` and ``use_pallas`` have no meaning here
    (a Python loop walks the layers; the kernels are always the card's)."""
    zero: str = "zero3"
    shard_model_axes: bool = True
    sequence_parallel: bool = True
    expert_parallel: bool = True
    remat: str = "dots"              # none | full | dots
    scan_layers: bool = True
    grad_dtype: str = "float32"      # float32 | bfloat16
    moe_impl: str = "gshard"
    decode_moe_impl: str = "dense"
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 512
    microbatches: int = 1            # gradient accumulation steps
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    z_loss: float = 1e-4             # unread, as in the JAX package (Model.loss)
    seed: int = 0


# ---------------------------------------------------------------------------
# architecture registry (populated by repro_torch.configs)
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str, smoke: Optional[Callable[[], ModelConfig]] = None
                  ) -> Callable:
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        _REGISTRY[name] = fn
        if smoke is not None:
            _SMOKE[name] = smoke
        return fn
    return deco


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    cfg.validate()
    return cfg


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    import repro_torch.configs  # noqa: F401
    if name not in _SMOKE:
        raise KeyError(f"no smoke config for {name!r}")
    cfg = _SMOKE[name]()
    cfg.validate()
    return cfg


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
