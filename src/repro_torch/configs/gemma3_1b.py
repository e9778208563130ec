"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144, 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt; unverified]  head_dim=256 (Gemma convention).

Port of ``repro/configs/gemma3_1b.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(name="gemma3-1b", n_layers=26, d_model=1152,
                    n_heads=4, n_kv_heads=1, d_head=256, d_ff=6912,
                    vocab=262144, window=512, global_every=6,
                    attn_chunk=1024, loss_chunk=512)


def smoke() -> LMConfig:
    return LMConfig(name="gemma3-smoke", n_layers=6, d_model=64,
                    n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
                    vocab=512, window=8, global_every=6,
                    attn_chunk=8, loss_chunk=8)


base.register(base.ArchSpec(
    arch_id="gemma3-1b", family="lm", full=full, smoke=smoke,
    shapes=base.LM_SHAPES, notes="5:1 local:global, window 512"))
