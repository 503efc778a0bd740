"""GPT-2 124M under pipeline parallelism: the JAX package's
``configs/gpt2_pp.py`` on this package's config schema.

A 4-stage pipeline over ``mesh.pp=4`` (one stage a rank) under the
interleaved 1F1B schedule (``parallel/pp.interleaved_1f1b``: the loss
inside the schedule, gradients out, an input stash of depth 2 x stages),
8 microbatches a step, bf16 compute over fp32 params, batch 32 x 1024.
The vocabulary is padded to 50304 (the data's ids stay below 50257), the
plain AdamW, ZeRO-1 inside each stage over the ranks ``dp=-1`` leaves.

Needs 4 ranks (``torchrun --nproc_per_node 4``); ``--override mesh.pp=1``
runs the same stacked stages back to back on one rank."""

from distributeddeeplearning_tpu_torch.config import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)


def get_config() -> Config:
    num_microbatches = 8
    return Config(
        model=ModelConfig(
            name="gpt2_pp",
            kwargs={
                "size": "124m",
                "max_len": 1024,
                "vocab_size": 50304,
                "num_stages": 4,
                "num_microbatches": num_microbatches,
                "schedule": "1f1b_interleaved",
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
        mesh=MeshConfig(dp=-1, pp=4),
    )
