"""Mixtral-class MoE LM (llama_moe 8x300m): the same configuration as the
JAX package's ``configs/llama_moe.py``, on this package's config schema.
Llama-300M's backbone (12 layers, 16 query heads over 8 KV heads, embed
1024, RoPE, RMSNorm) with every MLP a top-2-of-8 routed SwiGLU expert layer
of width 2816 at capacity factor 1.25 (``models/moe.py``), batch 16 x 2048,
bf16 compute over fp32 params, flash attention, the chunked head over the
untied 32000-word ``lm_head``, the plain AdamW (``optim.name='adamw'``, as
the reference ships it) and ZeRO-1 over the dp ranks.

``mesh.ep`` stays 1: expert parallelism is not ported yet (ROADMAP queue
A13). ``--override train.remat=full`` checkpoints each block; 'dots' is
refused, as the reference refuses it."""

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
            name="llama_moe",
            kwargs={
                "size": "8x300m",
                "max_len": 2048,
                "num_experts": 8,
                "num_selected": 2,
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
            name="adamw", lr=3e-4, b2=0.95, weight_decay=0.1,
            schedule="cosine", warmup_steps=200, grad_clip=1.0,
        ),
        train=TrainConfig(steps=1000, log_every=20, task="lm", zero1=True),
        mesh=MeshConfig(dp=-1, ep=1),
    )
