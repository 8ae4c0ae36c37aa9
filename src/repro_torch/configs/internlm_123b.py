"""internlm-123b — the paper's 123B pretraining workload (Fig. 10/11/12/14).
The exact config is unpublished; this reconstruction (96L, d_model 10240,
80H, GLU d_ff 27648, vocab 103168) lands on 123B parameters with the
llama-style layout the paper states its models follow. Runs on the CPU only
(smoke parity): at 6 bytes a parameter (fp32 masters, bf16 copies) it needs
far more than one 80 GB card. [paper §4.1]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm123-smoke", family="dense", num_layers=2, d_model=128,
        d_ff=384, vocab_size=512, max_seq_len=256,
        attention=AttentionConfig(num_heads=8, num_kv_heads=8, head_dim=16),
        vocab_pad_multiple=64)


@register_arch("internlm-123b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="internlm-123b", family="dense", num_layers=96, d_model=10240,
        d_ff=27648, vocab_size=103168, max_seq_len=32768,
        attention=AttentionConfig(num_heads=80, num_kv_heads=80,
                                  head_dim=128))
