"""Workload 2 (``BASELINE.json:8``): ResNet-50 on ImageNet, data parallel
over every rank, the north-star benchmark config (``BASELINE.json:2``:
"ResNet-50 ImageNet images/sec/chip"): the JAX package's
``configs/resnet50_imagenet.py`` on this package's config schema.

Synthetic ImageNet-shaped data (batch 256 of 224 x 224 x 3, 1000 classes),
bf16 convs over fp32 params, SGD with momentum 0.9 on a cosine schedule,
label smoothing 0.1. Under ``torchrun`` each rank takes its share of the
batch, and BatchNorm's statistics are all-reduced over the ranks."""

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
        model=ModelConfig(name="resnet50",
                          kwargs={"num_classes": 1000, "dtype": "bfloat16"}),
        data=DataConfig(
            kind="synthetic_image",
            batch_size=256,
            image_size=224,
            num_classes=1000,
            n_distinct=0,  # streaming: throughput measurement
        ),
        optim=OptimConfig(
            name="sgd", lr=0.4, momentum=0.9, schedule="cosine",
            warmup_steps=500, weight_decay=1e-4,
        ),
        train=TrainConfig(
            steps=1000, log_every=20, task="classification",
            label_smoothing=0.1,  # MLPerf ResNet recipe
        ),
        mesh=MeshConfig(dp=-1),
    )
