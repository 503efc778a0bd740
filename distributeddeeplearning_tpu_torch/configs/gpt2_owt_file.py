"""GPT-2 124M trained from a tokenized corpus on disk: the same
configuration as the JAX package's ``configs/gpt2_owt_file.py``, on this
package's config schema. The model, optimizer and mesh are
``configs/gpt2_owt.py``'s (batch 32 x 1024, bf16, flash attention, the
chunked tied head, the fused AdamW, ZeRO-1 over the dp ranks); the batches
come from a DDLTOK01 token file (``data_text.TokenFileLM``). Write one from
a UTF-8 text file with the byte tokenizer:

    python -m distributeddeeplearning_tpu_torch.prepare_data \\
        --input corpus.txt --output corpus.tok --tokenizer byte

and train with ``--override data.path=corpus.tok`` (the byte ids fit the
model's 50257 words). A batch is a pure function of (seed, index) and a
checkpoint stores the next index, so a resume is step-exact."""

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
            name="gpt2",
            kwargs={
                "size": "124m", "max_len": 1024, "attn_impl": "flash",
                "chunked_head": True,
                "dtype": "bfloat16",
            },
        ),
        data=DataConfig(
            kind="token_file_lm", batch_size=32, seq_len=1024,
            path="",  # required: --override data.path=<corpus.tok>
        ),
        optim=OptimConfig(
            name="adamw_fused", lr=6e-4, b2=0.95, weight_decay=0.1,
            schedule="cosine", warmup_steps=200, grad_clip=1.0,
        ),
        train=TrainConfig(
            steps=1000, log_every=20, task="lm", zero1=True,
            save_every=200, checkpoint_dir="/tmp/gpt2_owt_ckpt",
        ),
        mesh=MeshConfig(dp=-1),
    )
