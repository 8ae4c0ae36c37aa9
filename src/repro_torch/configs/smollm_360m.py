"""smollm-360m [dense]: 32L, d_model 960, 15H GQA(kv5), d_ff 2560,
vocab 49152 — llama-architecture small model, tied embeddings.
[hf:HuggingFaceTB/SmolLM-360M]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", family="dense", num_layers=2, d_model=120,
        d_ff=320, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(num_heads=6, num_kv_heads=2, head_dim=20),
        vocab_pad_multiple=64, tie_embeddings=True)


@register_arch("smollm-360m", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense", num_layers=32, d_model=960,
        d_ff=2560, vocab_size=49152, max_seq_len=32768,
        attention=AttentionConfig(num_heads=15, num_kv_heads=5, head_dim=64),
        tie_embeddings=True)
