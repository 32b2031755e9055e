"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]
d_inner=2048 (expand 2), headdim 64 → 32 SSD heads, 1 group, conv k=4."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab_size=50432,  # 50280 padded to /16 vocab shards
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
        ssm_chunk=256, ssm_conv=4, subquadratic=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m-reduced", family="ssm", num_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab_size=512,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_ngroups=1,
        ssm_chunk=16, ssm_conv=4, subquadratic=True)
