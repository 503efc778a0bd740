"""Workload 1 (``BASELINE.json:7``): ResNet-18 on CIFAR-10, plain SGD, with
synthetic CIFAR-shaped data: the JAX package's ``configs/resnet18_cifar10.py``
on this package's config schema."""

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
        model=ModelConfig(name="resnet18", kwargs={"num_classes": 10}),
        data=DataConfig(
            kind="synthetic_image",
            batch_size=128,
            image_size=32,
            num_classes=10,
        ),
        optim=OptimConfig(name="sgd", lr=0.1, momentum=0.9, schedule="cosine",
                          warmup_steps=5),
        train=TrainConfig(steps=200, log_every=10, task="classification"),
        mesh=MeshConfig(dp=-1),
    )
