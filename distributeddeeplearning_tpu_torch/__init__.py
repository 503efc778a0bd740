"""PyTorch/CUDA port of ``distributeddeeplearning_tpu``, slice by slice.

The paths that run on the GPU:
- serving: ``cli serve`` -> ``serving.ServingEngine`` -> GPT-2 in
  paged-decode mode, whose decode attention reads the paged KV pool through
  a CUDA kernel written for Hopper (``csrc/paged_attention.cu``);
- training: ``cli train`` -> ``train.Trainer`` -> GPT-2 on one GPU, with
  flash attention forward and backward (``csrc/flash_attention.cu``) and the
  fused AdamW update (``csrc/fused_adamw.cu``) as hand-written kernels;
- context-parallel training: ``cli train`` under ``torchrun`` over a
  ``mesh.Mesh`` of dp x cp ranks, ring attention over the cp ranks with its
  block attention in ``csrc/ring_attention.cu``, gradients averaged over
  every rank (``comms.py``);
- ZeRO-1 over the dp ranks (``parallel/zero.py``: each rank updates its
  shard of the moments with the fused AdamW kernel), gradient
  accumulation, checkpoints with step-exact resume on any mesh
  (``checkpoint.py``), evaluation (``cli eval``) and the metrics writer;
- ResNet-18/50 training (``models/resnet.py``: cuDNN convs, BatchNorm
  statistics synced over the dp ranks, SGD) on synthetic or C++-loaded
  images, and ``cli benchmark`` (``benchmark.py``), which prints the
  images/sec/chip record;
- ViT-L/16 and BERT-base training on the flash kernels' encoder masks,
  with per-block activation checkpointing (``models/remat.py``);
- Llama (``models/llama.py``: RoPE, RMSNorm, SwiGLU, grouped-query
  attention) trained on the flash kernels and served through the paged
  decode kernels at ``num_rep > 1``; ``hf_port.py`` carries HF weights
  into the port's models;
- the MoE decoders (``models/moe.py``: gpt2_moe, llama_moe) trained on the
  flash kernels with top-k capacity routing (``parallel/ep.py``), the
  router's aux loss and dropped fraction sown into the Trainer's step;
- the token-file corpus path (``data_text.py``, ``prepare_data.py``).
The package imports torch and never JAX; entry points run on the GPU unless
the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the GPU, and a GPU
    that is not there is an error, never a quiet switch to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            "— pass device='cpu' to run on the CPU"
        )
    return dev
