"""Workload 2, real-data variant (``BASELINE.json:8``): ResNet-50 trained
from an on-disk fixed-record image file with training augmentation: the
JAX package's ``configs/resnet50_imagenet_file.py`` on this package's
config schema.

File format: CIFAR-style binary records (``label_bytes`` label bytes, then
``image_size^2 * channels`` uint8 pixels, chw), served by the C++ loader
(``native/loader.py``; no fallback). Augmentation (random pad and crop,
horizontal flip) is a pure function of (seed, global sample index), so
resume is step-exact. Point ``data.eval_path`` at a held-out file; eval
never augments.

    python -m distributeddeeplearning_tpu_torch.cli train \\
        --config distributeddeeplearning_tpu_torch/configs/resnet50_imagenet_file.py \\
        --override data.path=train.bin --override data.eval_path=val.bin
"""

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
            name="resnet50", kwargs={"num_classes": 1000, "dtype": "bfloat16"}
        ),
        data=DataConfig(
            kind="record_file_image",
            batch_size=256,
            image_size=224,
            num_classes=1000,
            path="",  # required: --override data.path=<train.bin>
            label_bytes=2,  # 1000 classes
            augment=True,
            aug_pad=16,  # ~7% of 224 (the CIFAR-4-of-32 ratio)
        ),
        optim=OptimConfig(
            name="sgd", lr=0.4, momentum=0.9, weight_decay=1e-4,
            schedule="cosine", warmup_steps=1000,
        ),
        train=TrainConfig(
            label_smoothing=0.1,  # MLPerf ResNet recipe
            steps=450000,  # 90 epochs of 1.28M images at batch 256
            log_every=50,
            task="classification",
            eval_every=5000,
            save_every=5000,
            checkpoint_dir="/tmp/resnet50_file_ckpt",
        ),
        mesh=MeshConfig(dp=-1),
    )
