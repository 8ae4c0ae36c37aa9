"""mixtral-8x22b [moe]: 56L, d_model 6144, 48H GQA(kv8), vocab 32768,
MoE 8 experts top-2 with expert_ff 16384 on every layer; sliding-window
attention (4096). [arXiv:2401.04088; hf]

Runs on the CPU only (smoke parity): 141 B parameters do not fit one card
before the port shards a model (ROADMAP Queue 1 item 12).
"""
from repro_torch.config import (AttentionConfig, ModelConfig, MoEConfig,
                                register_arch)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe", num_layers=2, d_model=128,
        d_ff=0, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(num_heads=8, num_kv_heads=2, head_dim=16,
                                  sliding_window=64),
        moe=MoEConfig(num_experts=4, top_k=2, expert_ff=256),
        vocab_pad_multiple=64)


@register_arch("mixtral-8x22b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe", num_layers=56, d_model=6144,
        d_ff=0, vocab_size=32768, max_seq_len=524288,
        attention=AttentionConfig(num_heads=48, num_kv_heads=8,
                                  head_dim=128, sliding_window=4096),
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=16384))
