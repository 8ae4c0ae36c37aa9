"""h2o-danube-1.8b [dense]: 24L, d_model 2560, 32H GQA(kv8), head_dim 80,
d_ff 6912, vocab 32000 — llama+mistral mix with sliding-window attention
(window 4096 on every layer), untied embeddings. Served on the card at full
width and depth: 1.83 B parameters; every KV ring is sized at the window.
[arXiv:2401.16818; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch


def smoke() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="dense", num_layers=2, d_model=128,
        d_ff=384, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(num_heads=8, num_kv_heads=2, head_dim=16,
                                  sliding_window=64),
        vocab_pad_multiple=64)


@register_arch("h2o-danube-1.8b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense", num_layers=24, d_model=2560,
        d_ff=6912, vocab_size=32000, max_seq_len=524288,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=80,
                                  sliding_window=4096))
