"""deepseek-v2-lite-16b [moe]: 27L, d_model 2048, 16H MLA (kv_lora 512,
qk_rope 64, qk_nope 128, v_head 128), vocab 102400; first layer dense
(d_ff 10944), the rest MoE with 64 routed experts (expert_ff 1408, top-6)
plus 2 shared experts. [arXiv:2405.04434; hf]

The card serves it only at a cut depth: 15.7 B parameters at 6 bytes each
(fp32 masters and bf16 serving copies) are 94.2 GB, above one 80 GB H100.
``chip_smoke.py`` serves it at full width with its dense first layer and 7
MoE layers (4.59 B parameters, 27.6 GB). On the CPU, parity with the JAX
package covers the full depth only in the smoke config below.
"""
from repro_torch.config import (AttentionConfig, ModelConfig, MoEConfig,
                                register_arch)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe", num_layers=3, d_model=128,
        d_ff=0, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(kind="mla", num_heads=4, num_kv_heads=4,
                                  kv_lora_rank=32, qk_nope_dim=16,
                                  qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, num_shared_experts=1, top_k=2,
                      expert_ff=64, first_k_dense=1, first_dense_ff=256),
        vocab_pad_multiple=64)


@register_arch("deepseek-v2-lite-16b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", num_layers=27,
        d_model=2048, d_ff=0, vocab_size=102400, max_seq_len=32768,
        attention=AttentionConfig(kind="mla", num_heads=16, num_kv_heads=16,
                                  kv_lora_rank=512, qk_nope_dim=128,
                                  qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                      expert_ff=1408, first_k_dense=1,
                      first_dense_ff=10944))
