"""Workload 5 (``BASELINE.json:11``): ViT-L/16 on ImageNet-21k, data
parallel with activation checkpointing: the JAX package's
``configs/vit_imagenet21k.py`` on this package's config schema.

Synthetic 224 x 224 images (batch 64), 21843 classes, bf16 compute over
fp32 params, flash attention (the 197 tokens padded to 256, the padded
columns hidden by the kernels' static limit), the fused AdamW kernel on a
warmup-cosine schedule, and every encoder block checkpointed
(``train.remat='full'``)."""

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
            name="vit", kwargs={"size": "l16", "attn_impl": "flash",
                                "dtype": "bfloat16"}
        ),
        data=DataConfig(
            kind="synthetic_image", batch_size=64, image_size=224,
            num_classes=21843,
        ),
        optim=OptimConfig(
            name="adamw_fused", lr=1e-3, weight_decay=0.05, schedule="cosine",
            warmup_steps=500, grad_clip=1.0,
        ),
        train=TrainConfig(
            steps=1000, log_every=20, task="classification", remat="full",
        ),
        mesh=MeshConfig(dp=-1),
    )
