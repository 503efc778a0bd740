"""Tokenize raw text into the DDLTOK01 file the ``token_file_*`` kinds read
(``data_text.py``): the JAX package's ``prepare_data.py`` with its byte
tokenizer.

    python -m distributeddeeplearning_tpu_torch.prepare_data \\
        --input corpus.txt --output corpus.tok --tokenizer byte

``byte`` (the default) is the UTF-8 bytes, vocab 256, and needs no asset.
The reference's ``hf:<name>`` reads a HuggingFace tokenizer's files, which
this repository does not hold; it is refused by name.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .data_text import write_token_file


def tokenize_bytes(text: bytes) -> tuple[np.ndarray, int]:
    return np.frombuffer(text, dtype=np.uint8).astype(np.uint16), 256


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="prepare_data")
    p.add_argument("--input", required=True, help="raw text file (UTF-8)")
    p.add_argument("--output", required=True, help="DDLTOK01 output path")
    p.add_argument("--tokenizer", default="byte",
                   help="'byte' ('hf:<model name>' is not ported)")
    args = p.parse_args(argv)

    if args.tokenizer.startswith("hf:"):
        raise NotImplementedError(
            f"--tokenizer {args.tokenizer}: the HuggingFace tokenizer path "
            "not yet ported to distributeddeeplearning_tpu_torch (it needs "
            "a tokenizer's files, which the repository does not hold; "
            "ROADMAP queue A14) — use --tokenizer byte"
        )
    if args.tokenizer != "byte":
        raise SystemExit(f"unknown tokenizer {args.tokenizer!r}")
    with open(args.input, "rb") as f:
        tokens, vocab = tokenize_bytes(f.read())
    write_token_file(args.output, tokens, vocab)
    print(f"wrote {args.output}: {len(tokens):,} tokens, vocab {vocab}, "
          f"{'uint16' if vocab <= 1 << 16 else 'uint32'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
