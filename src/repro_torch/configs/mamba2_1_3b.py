"""mamba2-1.3b [ssm]: 48L, d_model 2048, attention-free, vocab 50280,
ssm_state 128 — SSD (state-space duality). d_inner = 2*d_model = 4096,
head_dim 64 (64 SSM heads), n_groups 1, conv width 4, chunk 256. Decode
carries an O(1) (B, H, P, N) state.
[arXiv:2405.21060]
"""
from repro_torch.config import ModelConfig, SSMConfig, register_arch


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", num_layers=2, d_model=96,
        d_ff=0, vocab_size=512, max_seq_len=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1,
                      conv_width=4, chunk_size=32),
        vocab_pad_multiple=64, tie_embeddings=True)


@register_arch("mamba2-1.3b", smoke=smoke)
def build() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
        d_ff=0, vocab_size=50280, max_seq_len=524288,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                      conv_width=4, chunk_size=256),
        tie_embeddings=True)
