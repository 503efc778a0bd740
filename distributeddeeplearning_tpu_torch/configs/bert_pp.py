"""BERT-base MLM under pipeline parallelism on padded batches: the JAX
package's ``configs/bert_pp.py`` on this package's config schema.

The encoder runs as a 4-stage pipeline over ``mesh.pp=4`` under the 1F1B
schedule (the stage inputs stashed, each stage's forward recomputed in
the backward), 8 microbatches a step. ``synthetic_mlm`` with
``pad_min_len`` makes rows of varying length with an ``attention_mask``,
which each stage reads for its own microbatch (masks never cross between
ranks). bf16 compute over fp32 params, batch 64 x 512, the vocabulary
padded to 30528 (the data's ids stay below 30522), the plain AdamW.

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
    return Config(
        model=ModelConfig(
            name="bert_pp",
            kwargs={
                "size": "base",
                "max_len": 512,
                "vocab_size": 30528,
                "num_stages": 4,
                "num_microbatches": 8,
                "schedule": "1f1b",
                "dtype": "bfloat16",
            },
        ),
        data=DataConfig(
            kind="synthetic_mlm", batch_size=64, seq_len=512,
            vocab_size=30522, pad_min_len=64,
        ),
        optim=OptimConfig(
            name="adamw", lr=1e-4, weight_decay=0.01,
            schedule="cosine", warmup_steps=500, grad_clip=1.0,
        ),
        train=TrainConfig(steps=1000, log_every=20, task="mlm"),
        mesh=MeshConfig(dp=-1, pp=4),
    )
