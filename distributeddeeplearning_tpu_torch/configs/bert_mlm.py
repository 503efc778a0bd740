"""Workload 3 (``BASELINE.json:9``): BERT-base MLM (Wikipedia), data
parallel with gradient accumulation: the JAX package's
``configs/bert_mlm.py`` on this package's config schema.

Synthetic masked-token batches (64 x 128, host-side masking of 15% of the
positions), vocab 30522, bf16 compute over fp32 params, flash attention
(padded batches through contiguous-prefix attention masks with
``data.pad_min_len``), the MLM loss through the chunked cross-entropy (the
[64, 128, 30522] fp32 logits never exist whole), the fused AdamW kernel on
a warmup-linear schedule, 4 microbatches a step."""

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
            name="bert",
            kwargs={
                "size": "base", "vocab_size": 30522, "max_len": 512,
                "attn_impl": "flash", "chunked_head": True,
                "dtype": "bfloat16",
            },
        ),
        data=DataConfig(
            kind="synthetic_mlm", batch_size=64, seq_len=128,
            vocab_size=30522,
        ),
        optim=OptimConfig(
            name="adamw_fused", lr=1e-4, weight_decay=0.01, schedule="linear",
            warmup_steps=100, grad_clip=1.0,
        ),
        train=TrainConfig(
            steps=1000, log_every=20, task="mlm", grad_accum=4,
        ),
        mesh=MeshConfig(dp=-1),
    )
