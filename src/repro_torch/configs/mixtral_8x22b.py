"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

Port of ``repro/configs/mixtral_8x22b.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(name="mixtral-8x22b", n_layers=56, d_model=6144,
                    n_heads=48, n_kv_heads=8, d_head=128, d_ff=16384,
                    vocab=32768, moe_experts=8, moe_top_k=2,
                    window=4096, attn_chunk=1024, loss_chunk=512)


def smoke() -> LMConfig:
    return LMConfig(name="mixtral-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                    vocab=512, moe_experts=4, moe_top_k=2, window=8,
                    attn_chunk=8, loss_chunk=8)


base.register(base.ArchSpec(
    arch_id="mixtral-8x22b", family="lm", full=full, smoke=smoke,
    shapes=base.LM_SHAPES, notes="8 experts top-2, SWA 4096"))
