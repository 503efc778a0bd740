"""Ops of the port: each hand-written kernel sits beside its plain torch
version in the same module (``paged_attention``, ``flash_attention``,
``fused_adamw``, ``ring_attention_pallas``); ``_build`` compiles the CUDA
sources at first use. ``ring_attention`` is the plain ring, which has no
kernel of its own."""
