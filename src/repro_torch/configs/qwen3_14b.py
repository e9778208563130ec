"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]

Port of ``repro/configs/qwen3_14b.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(name="qwen3-14b", n_layers=40, d_model=5120,
                    n_heads=40, n_kv_heads=8, d_head=128, d_ff=17408,
                    vocab=151936, qk_norm=True,
                    attn_chunk=1024, loss_chunk=512)


def smoke() -> LMConfig:
    return LMConfig(name="qwen3-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                    vocab=512, qk_norm=True, attn_chunk=8, loss_chunk=8)


base.register(base.ArchSpec(
    arch_id="qwen3-14b", family="lm", full=full, smoke=smoke,
    shapes=base.LM_SHAPES, notes="qk_norm, GQA"))
