"""GPT-2-shaped Mixture-of-Experts LM: the same configuration as the JAX
package's ``configs/gpt2_moe.py``, on this package's config schema. GPT-2
124M whose every other block routes its MLP top-2 over 8 experts at
capacity factor 1.25 (``models/moe.py``), batch 32 x 1024, bf16 compute
over fp32 params, flash attention, the chunked tied head, the plain AdamW
(``optim.name='adamw'``, as the reference ships it) and ZeRO-1 over the dp
ranks.

``mesh.ep`` stays 1: expert parallelism is not ported yet (ROADMAP queue
A13), so the experts run on every rank. The model has no activation
checkpointing (``train.remat`` is refused, as the reference refuses it),
and serving it is refused (the capacity-MoE serving fence)."""

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
            name="gpt2_moe",
            kwargs={
                "size": "124m",
                "max_len": 1024,
                "num_experts": 8,
                "num_selected": 2,
                "capacity_factor": 1.25,
                "moe_every": 2,
                "attn_impl": "flash",
                "chunked_head": True,
                "dtype": "bfloat16",
            },
        ),
        data=DataConfig(
            kind="synthetic_tokens", batch_size=32, seq_len=1024,
            vocab_size=50257,
        ),
        optim=OptimConfig(
            name="adamw", lr=6e-4, b2=0.95, weight_decay=0.1,
            schedule="cosine", warmup_steps=200, grad_clip=1.0,
        ),
        train=TrainConfig(steps=1000, log_every=20, task="lm", zero1=True),
        mesh=MeshConfig(dp=-1, ep=1),
    )
