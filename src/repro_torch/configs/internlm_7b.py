"""internlm-7b — the paper's own 7B model family (§2.2: "LLMs ranging from
7B to over 123B ... transformer-based decoder-only architecture, similar to
GPT and LLaMA"): 32L, d_model 4096, 32H MHA, head_dim 128, d_ff 11008,
vocab 103168. Runs on the CPU (smoke parity); serving it on the card waits
for ROADMAP item 17b (a decode horizon for its 32768-slot rings beside
43.9 GB of fp32 masters and bf16 copies). [hf:internlm/internlm-7b; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm7-smoke", family="dense", num_layers=2, d_model=128,
        d_ff=384, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(num_heads=8, num_kv_heads=8, head_dim=16),
        vocab_pad_multiple=64)


@register_arch("internlm-7b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="internlm-7b", family="dense", num_layers=32, d_model=4096,
        d_ff=11008, vocab_size=103168, max_seq_len=32768,
        attention=AttentionConfig(num_heads=32, num_kv_heads=32,
                                  head_dim=128))
