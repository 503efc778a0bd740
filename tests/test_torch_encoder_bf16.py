"""ViT's and BERT's bf16 forward against the JAX package's bf16 forward on
the same fp32 weights, at tp = 1: the pin on ``transformer.SelfAttention``
and ``transformer.Mlp`` (which tensor parallelism changed, and ViT and BERT
share) that the fp32 tests of ``test_torch_vit.py`` and
``test_torch_bert.py`` do not give for bf16.

Both packages round the projections, the residual stream and the head's
output to bf16, so the logits may sit two bf16 roundings apart (rtol 2**-6
plus atol 1e-2) and the loss two roundings (rtol 2**-6), as the pipelined
BERT's bf16 hold. The weights are the port's draw with every leaf redrawn
from a seeded generator (LayerNorm scales near one, the rest small), so no
logit is trivially zero; the fp32 forward on them differs (bf16 is
load-bearing)."""

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import models, train

import torch_sharded as ts

CASES = {
    "vit": dict(size="tiny", image_size=32, num_classes=10),
    "bert": dict(size="tiny", vocab_size=64, max_len=32),
}


def _weights(name):
    model = models.get_model(name, **CASES[name])
    rng = np.random.default_rng(0)
    flat = {}
    for k, v in model.state_dict().items():
        noise = torch.from_numpy(
            rng.standard_normal(tuple(v.shape)).astype(np.float32))
        flat[k] = 1.0 + 0.1 * noise if k.endswith("scale") else 0.05 * noise
    return flat


def _batch(name):
    if name == "vit":
        rng = np.random.default_rng(1)
        return {"image": rng.standard_normal((3, 32, 32, 3)).astype(
                    np.float32),
                "label": np.array([1, 4, 9], np.int32)}
    from distributeddeeplearning_tpu_torch import data

    batch = data.SyntheticMLM(batch_size=3, seq_len=32, vocab_size=64,
                              pad_min_len=8).batch(1)
    assert batch["attention_mask"].sum(1).min() < 32  # some rows padded
    return batch


def _port(name, flat, batch, dtype):
    model = models.get_model(name, **CASES[name], dtype=dtype)
    model.load_state_dict(flat, strict=True)
    task = train.get_task("classification" if name == "vit" else "mlm")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = model(*task.input_fn(tb))
        return logits, float(task.loss_fn(logits, tb)[0])


def _jax(name, flat, batch):
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import models as jm
    from distributeddeeplearning_tpu.train import get_task

    model = jm.get_model(name, **CASES[name], dtype=jnp.bfloat16)
    task = get_task("classification" if name == "vit" else "mlm")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = model.apply({"params": ts.jax_tree(flat)}, *task.input_fn(jb))
    return np.asarray(logits, np.float32), float(task.loss_fn(logits, jb)[0])


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_forward_matches_jax(name):
    flat, batch = _weights(name), _batch(name)
    logits, loss = _port(name, flat, batch, "bfloat16")
    jlogits, jloss = _jax(name, flat, batch)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=2 ** -6,
                               atol=1e-2)
    np.testing.assert_allclose(loss, jloss, rtol=2 ** -6)
    f32, _ = _port(name, flat, batch, "float32")
    assert not torch.equal(f32, logits)
