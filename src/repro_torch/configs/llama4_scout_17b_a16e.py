"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Note: Scout interleaves chunked-local / global attention (iRoPE); we
model all layers as global full attention with chunked (online-softmax)
computation, which matches FLOPs/bytes for the assigned shapes.

Port of ``repro/configs/llama4_scout_17b_a16e.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(name="llama4-scout-17b-a16e", n_layers=48,
                    d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
                    d_ff=8192, vocab=202048, moe_experts=16, moe_top_k=1,
                    attn_chunk=1024, loss_chunk=512)


def smoke() -> LMConfig:
    return LMConfig(name="llama4-scout-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                    vocab=512, moe_experts=4, moe_top_k=1,
                    attn_chunk=8, loss_chunk=8)


base.register(base.ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="lm", full=full, smoke=smoke,
    shapes=base.LM_SHAPES, notes="MoE top-1, 16 experts (16-way EP)"))
