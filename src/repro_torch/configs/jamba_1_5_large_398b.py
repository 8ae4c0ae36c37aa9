"""jamba-1.5-large-398b [hybrid]: 72L, d_model 8192, 64H GQA(kv8),
d_ff 24576, vocab 65536; Mamba+attention 1:7 interleave (one attention
layer per 8-layer block) with MoE (16 experts, top-2) on every other layer.
As in the JAX package, the Mamba-2 SSD block (state 128, head 64) stands in
for Jamba's Mamba-1 selective scan. [arXiv:2403.19887; hf]

Runs on the CPU only (smoke parity): 398 B parameters do not fit one card
before the port shards a model (ROADMAP Queue 1 item 12).
"""
from repro_torch.config import (AttentionConfig, ModelConfig, MoEConfig,
                                SSMConfig, register_arch)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid", num_layers=8, d_model=128,
        d_ff=256, vocab_size=512, max_seq_len=256,
        attn_every=8, attn_index=4,
        attention=AttentionConfig(num_heads=8, num_kv_heads=2, head_dim=16),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1,
                      chunk_size=32),
        moe=MoEConfig(num_experts=4, top_k=2, expert_ff=256, moe_every=2,
                      moe_offset=1),
        vocab_pad_multiple=64)


@register_arch("jamba-1.5-large-398b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", num_layers=72,
        d_model=8192, d_ff=24576, vocab_size=65536, max_seq_len=524288,
        attn_every=8, attn_index=4,
        attention=AttentionConfig(num_heads=64, num_kv_heads=8,
                                  head_dim=128),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=8,
                      chunk_size=256),
        moe=MoEConfig(num_experts=16, top_k=2, expert_ff=24576,
                      moe_every=2, moe_offset=1))
