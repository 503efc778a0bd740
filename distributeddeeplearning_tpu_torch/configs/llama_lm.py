"""Llama-300M causal LM, the modern-decoder workload: the same configuration
as the JAX package's ``configs/llama_lm.py``, on this package's config
schema. RoPE, RMSNorm, SwiGLU and grouped-query attention (16 query heads
over 8 KV heads) through the same trainer, kernels and mesh as GPT-2:
batch 16 x 2048, bf16 compute over fp32 params, flash attention, the
chunked head over the untied 32000-word ``lm_head``, the fused AdamW, and
ZeRO-1 over the dp ranks.

Long sequences: ``--override model.kwargs.attn_impl=ring --override
mesh.cp=2`` (under ``torchrun``) splits the sequence over the cp ranks.
Serving it needs ``model.kwargs.attn_impl=xla`` and, through ``cli
serve``, the byte tokenizer's ``model.kwargs.vocab_size=256``."""

from distributeddeeplearning_tpu_torch.config import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)


def get_config() -> Config:
    return Config(
        model=ModelConfig(
            name="llama",
            kwargs={
                "size": "300m",
                "max_len": 2048,
                "attn_impl": "flash",
                "chunked_head": True,
                "dtype": "bfloat16",
            },
        ),
        data=DataConfig(
            kind="synthetic_tokens", batch_size=16, seq_len=2048,
            vocab_size=32000,
        ),
        optim=OptimConfig(
            name="adamw_fused", lr=3e-4, b2=0.95, weight_decay=0.1,
            schedule="cosine", warmup_steps=200, grad_clip=1.0,
        ),
        train=TrainConfig(steps=1000, log_every=20, task="lm", zero1=True),
        mesh=MeshConfig(dp=-1),
    )
