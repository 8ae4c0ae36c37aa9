"""nemotron-4-15b [dense]: 32L, d_model 6144, 48H GQA(kv8), d_ff 24576,
vocab 256000 — squared-ReLU MLP (no GLU), full attention. Runs on the CPU
only (smoke parity): at 6 bytes a parameter (fp32 masters, bf16 copies) it
needs more than one 80 GB card. [arXiv:2402.16819; unverified]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense", num_layers=2, d_model=96,
        d_ff=384, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(num_heads=6, num_kv_heads=2, head_dim=16),
        mlp_act="relu2", vocab_pad_multiple=64)


@register_arch("nemotron-4-15b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", num_layers=32, d_model=6144,
        d_ff=24576, vocab_size=256000, max_seq_len=32768,
        attention=AttentionConfig(num_heads=48, num_kv_heads=8,
                                  head_dim=128),
        mlp_act="relu2")
