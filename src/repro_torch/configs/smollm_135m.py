"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

Port of ``repro/configs/smollm_135m.py``, the same field values.
"""
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(name="smollm-135m", n_layers=30, d_model=576,
                    n_heads=9, n_kv_heads=3, d_head=64, d_ff=1536,
                    vocab=49152, attn_chunk=1024, loss_chunk=512)


def smoke() -> LMConfig:
    return LMConfig(name="smollm-smoke", n_layers=2, d_model=36,
                    n_heads=3, n_kv_heads=3, d_head=12, d_ff=96,
                    vocab=512, attn_chunk=8, loss_chunk=8)


base.register(base.ArchSpec(
    arch_id="smollm-135m", family="lm", full=full, smoke=smoke,
    shapes=base.LM_SHAPES, notes="llama-arch small; ~135M params"))
