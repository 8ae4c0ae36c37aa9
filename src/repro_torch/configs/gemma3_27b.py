"""gemma3-27b [dense]: 62L, d_model 5376, 32H GQA(kv16), d_ff 21504,
vocab 262144; 5 local(1024-window) : 1 global attention interleave, GELU-GLU,
tied embeddings. Runs on the CPU only (smoke parity): at 6 bytes a
parameter (fp32 masters, bf16 copies) it needs more than one 80 GB card.
[hf:google/gemma-3-*-pt; unverified]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense", num_layers=6, d_model=96,
        d_ff=256, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=24,
                                  global_every=6, local_window=32),
        mlp_act="gelu_glu", vocab_pad_multiple=64)


@register_arch("gemma3-27b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense", num_layers=62, d_model=5376,
        d_ff=21504, vocab_size=262144, max_seq_len=524288,
        attention=AttentionConfig(num_heads=32, num_kv_heads=16,
                                  head_dim=128, rope_theta=1_000_000.0,
                                  global_every=6, local_window=1024),
        mlp_act="gelu_glu", tie_embeddings=True)
