"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small. [arXiv:2401.02385; hf]"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b", family="dense", num_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_head=64, d_ff=5632, vocab_size=32000,
        ffn="swiglu", attn_shard="heads")


def reduced() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b-reduced", family="dense", num_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        vocab_size=512, ffn="swiglu", attn_shard="heads")
