"""Shared setting of the port's serving-feature tests
(``tests/test_torch_serving_*.py``): the tiny GPT-2 of
``tests/test_torch_serving.py`` (vocab 97, JAX's init at seed 7, loaded
into the port through ``from_jax_params``), a deterministic clock, wave
runners, and the decoding of a block's raw bytes into its KV by (layer,
pool tensor) on either side, so blocks compare by value across the two
frameworks' layouts."""

import flax.linen as nn
import jax
import numpy as np
import torch

from distributeddeeplearning_tpu import models as jax_models
from distributeddeeplearning_tpu_torch import models
from distributeddeeplearning_tpu_torch.weights import from_jax_params

KW = dict(size="tiny", vocab_size=97, max_len=64)
POOL_NAMES = ("pool_key", "pool_key_scale", "pool_value", "pool_value_scale")


def fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    return clock


def jax_weights():
    jm = jax_models.get_model("gpt2", **KW)
    params = jm.init(jax.random.PRNGKey(7), np.zeros((1, 8), np.int32))
    return jm, jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))


def port_model(params):
    tm = models.get_model("gpt2", **KW)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return tm


def prompts(lens, seed=42):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 97, n))) for n in lens]


def run_waves(eng, req_cls, waves, max_new):
    """Submit and drain each wave before the next; per wave, each
    request's generated tokens in submit order."""
    out = []
    for wave in waves:
        for p in wave:
            eng.submit(req_cls(prompt=list(p), max_new_tokens=max_new))
        out.append([list(s.generated) for s in eng.run()])
        eng.scheduler.finished.clear()
    return out


def jax_block(jeng, raw: bytes) -> dict:
    """A JAX engine's raw block bytes -> {(layer, name): f32 array}."""
    out, off = {}, 0
    flat = jax.tree_util.tree_flatten_with_path(jeng._cache)[0]
    for path, leaf in flat:
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] not in POOL_NAMES:
            continue
        layer = next(int(k.split("_")[1]) for k in keys
                     if isinstance(k, str) and k.startswith("block_"))
        count = int(np.prod(leaf.shape[1:]))
        dt = np.dtype(leaf.dtype)
        arr = np.frombuffer(raw, dtype=dt, count=count, offset=off)
        out[(layer, keys[-1])] = arr.reshape(leaf.shape[1:]).astype(
            np.float32)
        off += count * dt.itemsize
    assert off == len(raw)
    return out


def port_block(eng, raw) -> dict:
    """The port engine's raw block bytes (``bytes`` or a uint8 tensor) ->
    {(layer, name): f32 array}."""
    if isinstance(raw, bytes):
        raw = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    out, off = {}, 0
    for layer, pools in enumerate(eng._pools):
        for name in sorted(pools):
            leaf = pools[name]
            nb = leaf[0].numel() * leaf.element_size()
            out[(layer, name)] = raw[off:off + nb].view(leaf.dtype).reshape(
                leaf.shape[1:]).float().numpy()
            off += nb
    assert off == raw.numel()
    return out


def assert_blocks_close(got: dict, want: dict, tol=1e-5):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol,
                                   err_msg=str(key))
