"""Chunked tied-head softmax cross-entropy: the LM head without its logits.

A ``chunked_head=True`` model returns its final hidden states and the tied
decoder instead of ``[B, L, V]`` logits. :func:`chunked_xent` walks the
sequence in chunks: each chunk's ``[B, Lc, V]`` logits are computed,
reduced to per-token cross-entropy and dropped, and
``torch.utils.checkpoint`` makes the backward recompute each chunk's logits
instead of keeping them (the reference's ``jax.checkpoint`` over a
``lax.scan``). At GPT-2 124M's training shapes the full logits would be
``[32, 1024, 50257]`` fp32, 6.6 GB; one chunk of 128 positions is 1/8 of it.
A caller that needs logits at a few positions only (sampling at the last
prompt token) reads them from the same output.

A decoder cut over tp holds its slice of the vocabulary: its output names
the slice (``vocab``, a ``parallel.tp.VocabShard``), and each chunk's
softmax is taken over the slices together: the max of the local logits
all-reduced over tp (detached: a shift), the sum of the exponentials
all-reduced over tp, the target's logit from the rank that holds it. Every
tp rank gets the same per-token loss, and each rank's logits the gradient
of their own columns. A head with a bias (BERT's ``mlm_bias``) holds the
same slice of it, added to the slice's logits first. The collectives run
again, in the same order on every rank, when the backward recomputes a
chunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# hidden [B, L, E] (final, post-LN), emb [V, E] tied decoder, bias [V] or
# absent.
ChunkedHeadOut = dict


def head_output(hidden, emb, bias=None, *, vocab=None) -> ChunkedHeadOut:
    """What a ``chunked_head=True`` model returns. A parameter passed as it
    is (an fp32 decoder, a bias) is returned as a view: a module's output
    that is a leaf tensor breaks module backward hooks, such as those of
    ``FlopCounterMode`` in the benchmark. ``vocab``: the rank's slice of
    the vocabulary that ``emb`` holds, under tp."""
    out = {"hidden": hidden, "emb": emb.view_as(emb)}
    if bias is not None:
        out["bias"] = bias.view_as(bias)
    if vocab is not None:
        out["vocab"] = vocab
    return out


def is_chunked_head(out) -> bool:
    return isinstance(out, dict) and "hidden" in out and "emb" in out


def _chunk_xent(hc, emb, tc, bias=None):
    """Per-token xent [B, Lc] fp32 of one chunk: logits in the compute
    dtype (as the tied head computes them), cast to fp32 for the softmax."""
    logits = torch.einsum("ble,ve->blv", hc, emb)
    if bias is not None:
        logits = logits + bias
    B, Lc, V = logits.shape
    return F.cross_entropy(logits.float().reshape(B * Lc, V),
                           tc.reshape(-1).long(),
                           reduction="none").reshape(B, Lc)


def _chunk_xent_vocab_parallel(hc, emb, tc, vocab, bias=None):
    """:func:`_chunk_xent` over this rank's vocabulary slice (``emb``
    [rows, E], rows ``[vocab.lo, vocab.lo + vocab.valid)`` of the whole;
    ``bias`` [rows]: the same slice of the bias, joined to the slice's
    logits before the softmax over the slices)."""
    from .. import comms

    mesh = vocab.mesh
    logits = torch.einsum("ble,ve->blv", hc, emb)
    if bias is not None:
        logits = logits + bias
    logits = logits.float()
    rows = logits.shape[-1]
    if vocab.valid < rows:  # the padded rows of the last rank's slice
        cols = torch.arange(rows, device=logits.device)
        logits = logits.masked_fill(cols >= vocab.valid, float("-inf"))
    shift = comms.pmax(logits.detach().amax(-1), mesh, "tp")
    z = logits - shift[..., None]
    total = comms.psum_identity_bwd(z.exp().sum(-1), mesh, "tp")
    local = tc.long() - vocab.lo
    own = (local >= 0) & (local < vocab.valid)
    picked = z.gather(-1, torch.where(own, local, 0)[..., None])[..., 0]
    target = comms.psum_identity_bwd(
        torch.where(own, picked, torch.zeros_like(picked)), mesh, "tp")
    return torch.log(total) - target


def chunked_xent(out: ChunkedHeadOut, targets, *, seq_chunk: int = 128):
    """Per-token softmax cross-entropy [B, L] fp32 without full logits.

    ``targets`` [B, L] int, in-vocab. ``seq_chunk`` positions have their
    logits alive at once; the last chunk may be shorter (the reference pads
    it and drops the pad, which is the same function)."""
    hidden, emb = out["hidden"], out["emb"]
    bias, vocab = out.get("bias"), out.get("vocab")
    L = hidden.shape[1]
    seq_chunk = max(1, min(seq_chunk, L))
    per_tok = []
    for lo in range(0, L, seq_chunk):
        hc = hidden[:, lo:lo + seq_chunk]
        tc = targets[:, lo:lo + seq_chunk]
        if vocab is not None:
            per_tok.append(checkpoint(_chunk_xent_vocab_parallel, hc, emb,
                                      tc, vocab, bias, use_reentrant=False))
            continue
        per_tok.append(checkpoint(_chunk_xent, hc, emb, tc, bias,
                                  use_reentrant=False))
    return torch.cat(per_tok, dim=1)
