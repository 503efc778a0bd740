"""The port's prefix cache and host spill tier against the JAX package's
live engine.

The same tiny GPT-2 weights (``from_jax_params``) and the same traces run
through the JAX engine and the port's on the CPU; each JAX configuration
is built and run once per module (``_jax``). Greedy tokens must be
identical per request, and the scheduler's end state (hit and miss
tokens, decode-route admissions, spills, promotions, evictions) equal.
The port runs both read paths: 'pallas' (the paged kernel's plain version
here) and 'reference' (the gather).

- prefix cache: a 16-token shared prefix (two blocks of 8) under suffixes
  of 1, 3, 6 and 8 tokens and one unshared prompt, in two waves: cold,
  partial hits (suffix-only prefill at a nonzero cursor, suffix buckets 4
  and 8), full-prefix hits (the decode route), fp and int8 KV pools; the
  tiny Llama too (the cursor through RoPE, GQA);
- spill tier: two prefixes alternating on a pool cut so the off-duty one
  spills and comes back, the 'fp' and 'int8' codecs and an int8 pool
  through 'fp'; the spill file saved, the pool emptied, the file loaded
  and promoted; the file round-trips bit for bit within the port, and the
  spilled KV equals JAX's by (layer, block, position, head, dim).
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.config import ServingConfig as JaxServing
from distributeddeeplearning_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxEngine,
)
from distributeddeeplearning_tpu_torch.config import ServingConfig
from distributeddeeplearning_tpu_torch.serving import Request, ServingEngine
from torch_serving import (
    assert_blocks_close,
    fake_clock,
    jax_weights,
    port_block,
    port_model,
    run_waves,
)

torch.set_num_threads(2)

_BASE = dict(slots=3, block_size=8, hbm_budget_mb=8, max_seq_len=48,
             prompt_buckets=(8, 24), prefix_cache=True, suffix_buckets=(4,))
_SPILL = dict(_BASE, slots=2, spill_blocks=12)
_CONSTRAIN = 8  # device blocks: below the two prefixes' working set
_MAX_NEW = 7


@pytest.fixture(scope="module")
def weights():
    return jax_weights()


def _prefix_waves():
    rng = np.random.default_rng(3)
    prefix = list(map(int, rng.integers(1, 97, 16)))
    wave = [prefix + list(map(int, rng.integers(1, 97, n)))
            for n in (3, 1, 6, 8)]
    wave.append(list(map(int, rng.integers(1, 97, 5))))
    return [wave, [list(p) for p in wave]]


def _alternating_waves():
    rng = np.random.default_rng(5)
    pa = list(map(int, rng.integers(1, 97, 16)))
    pb = list(map(int, rng.integers(1, 97, 16)))
    return [[prefix + list(map(int, rng.integers(1, 97, 2 + (w + j) % 3)))
             for j in range(2)]
            for w, prefix in enumerate((pa, pb, pa, pb, pa))]


def _run_waves(eng, req_cls, waves):
    return run_waves(eng, req_cls, waves, _MAX_NEW)


def _spill_round_trip(eng, req_cls, path, wave):
    """Save the spill store, empty both tiers (a fresh pool of the same
    size), load the file, then serve ``wave`` (its prefixes come back from
    the loaded store)."""
    saved = eng.save_spill_store(str(path))
    eng.constrain_pool(_CONSTRAIN)
    assert not eng._spill_store
    loaded = eng.load_spill_store(str(path))
    return saved, loaded, _run_waves(eng, req_cls, [wave])


_JAX: dict = {}


def _jax(weights, name, cfg, waves, constrain=0, tmp=None):
    """The JAX engine's run of ``waves`` under ``cfg``, once per module."""
    if name not in _JAX:
        jm, params = weights
        eng = JaxEngine(jm, params, JaxServing(**cfg), clock=fake_clock())
        if constrain:
            eng.constrain_pool(constrain)
        got = _run_waves(eng, JaxRequest, waves)
        out = {"tokens": got, "eng": eng,
               "stats": eng.scheduler.stats()}
        if cfg.get("spill_blocks"):
            out["spill_stats"] = dict(eng.spill_stats)
            out["store"] = dict(eng._spill_store)
            out["round_trip"] = _spill_round_trip(
                eng, JaxRequest, tmp / f"jax_{name}.pkl", waves[0])
        _JAX[name] = out
    return _JAX[name]


@pytest.mark.parametrize("kernel", ["pallas", "reference"])
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_prefix_cache_matches_jax(weights, kv_quant, kernel):
    waves = _prefix_waves()
    want = _jax(weights, f"prefix_{kv_quant}",
                dict(_BASE, kv_quant=kv_quant), waves)
    eng = ServingEngine(
        port_model(weights[1]),
        ServingConfig(**_BASE, kv_quant=kv_quant, attn_kernel=kernel),
        clock=fake_clock(), device="cpu")
    assert _run_waves(eng, Request, waves) == want["tokens"]
    st = eng.scheduler.stats()
    assert st == want["stats"]
    pc = st["prefix_cache"]
    # cold, partial and full-prefix hits, and a suffix bucket, all ran
    assert pc["hit_tokens"] > 0 and pc["miss_tokens"] > 0
    assert pc["decode_route_admits"] > 0
    assert eng.calls["prefill"] == want["eng"].calls["prefill"]
    assert eng.calls["decode"] == want["eng"].calls["decode"]
    assert {e.get("bucket") for e in eng.events
            if e["event"] == "request_admitted"} >= {4, 8, 24, 0}


def test_prefix_cache_on_llama_matches_jax():
    """The cursor through RoPE: the tiny Llama (4 query heads over 2 KV
    heads) on the same waves, greedy tokens and scheduler state equal to
    JAX's."""
    import flax.linen as nn
    import jax

    from distributeddeeplearning_tpu import models as jax_models
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    kw = dict(size="tiny", vocab_size=97, max_len=64)
    jm = jax_models.get_model("llama", **kw)
    params = jax.tree.map(np.asarray, nn.meta.unbox(jm.init(
        jax.random.PRNGKey(7), np.zeros((1, 8), np.int32))["params"]))
    waves = _prefix_waves()
    jeng = JaxEngine(jm, params, JaxServing(**_BASE), clock=fake_clock())
    tm = models.get_model("llama", **kw)
    tm.load_state_dict(from_jax_params(params), strict=True)
    eng = ServingEngine(tm, ServingConfig(**_BASE, attn_kernel="pallas"),
                        clock=fake_clock(), device="cpu")
    assert eng.model.num_kv_heads == 2
    assert _run_waves(eng, Request, waves) == _run_waves(
        jeng, JaxRequest, waves)
    assert eng.scheduler.stats() == jeng.scheduler.stats()
    assert eng.scheduler.stats()["prefix_cache"]["decode_route_admits"]


def test_prefix_cache_tokens_equal_cache_off(weights):
    waves = _prefix_waves()
    off = ServingEngine(
        port_model(weights[1]),
        ServingConfig(**dict(_BASE, prefix_cache=False, suffix_buckets=()),
                      attn_kernel="pallas"),
        clock=fake_clock(), device="cpu")
    want = _jax(weights, "prefix_off", dict(_BASE, kv_quant="off"), waves)
    assert _run_waves(off, Request, waves) == want["tokens"]
    assert "prefix_cache" not in off.scheduler.stats()


def _jax_names(jeng):
    """(layer, pool name) of the JAX engine's pool leaves in its order."""
    import jax

    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(jeng._cache)[0]:
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] in ("pool_key", "pool_value"):
            out.append((next(int(k.split("_")[1]) for k in keys
                             if isinstance(k, str)
                             and k.startswith("block_")), keys[-1]))
    return out


_SPILL_CASES = {
    "fp": dict(_SPILL),
    "int8": dict(_SPILL, spill_codec="int8"),
    "kv_int8": dict(_SPILL, kv_quant="int8"),
}


@pytest.mark.parametrize("case", sorted(_SPILL_CASES))
def test_spill_tier_matches_jax(weights, tmp_path_factory, case):
    cfg = _SPILL_CASES[case]
    waves = _alternating_waves()
    tmp = tmp_path_factory.mktemp(case)
    want = _jax(weights, f"spill_{case}", cfg, waves, _CONSTRAIN, tmp)
    eng = ServingEngine(port_model(weights[1]),
                        ServingConfig(**cfg, attn_kernel="pallas"),
                        clock=fake_clock(), device="cpu")
    eng.constrain_pool(_CONSTRAIN)
    assert _run_waves(eng, Request, waves) == want["tokens"]
    assert eng.scheduler.stats() == want["stats"]
    pc = eng.scheduler.stats()["prefix_cache"]
    assert pc["spills"] > 0 and pc["promotes"] > 0
    assert pc["hit_tokens_host"] > 0
    assert eng.spill_stats == want["spill_stats"]
    assert set(eng._spill_store) == set(want["store"])
    if case == "fp":
        # the spilled KV by (layer, block position, head, dim)
        for h, (codec, raw) in eng._spill_store.items():
            assert codec == "fp"
            want_rows = want["store"][h][1]
            assert_blocks_close(port_block(eng, raw), {
                key: np.asarray(rows, np.float32)
                for key, rows in zip(_jax_names(want["eng"]), want_rows)})
    path = tmp / "port.pkl"
    saved, loaded, got = _spill_round_trip(eng, Request, path, waves[0])
    assert (saved, loaded) == want["round_trip"][:2] and saved > 0
    assert got == want["round_trip"][2]
    assert eng.scheduler.stats() == want["eng"].scheduler.stats()
    # the port's file round-trips bit for bit: load it into a fresh pool
    # and save again
    fresh = ServingEngine(port_model(weights[1]),
                          ServingConfig(**cfg, attn_kernel="pallas"),
                          clock=fake_clock(), device="cpu")
    assert fresh.load_spill_store(str(path)) == loaded
    fresh.save_spill_store(str(tmp / "again.pkl"))
    with open(path, "rb") as a, open(tmp / "again.pkl", "rb") as b:
        one, two = pickle.load(a), pickle.load(b)
    assert one["meta"] == two["meta"]
    key = lambda r: r["chain_hash"]  # noqa: E731
    for r1, r2 in zip(sorted(one["records"], key=key),
                      sorted(two["records"], key=key)):
        assert (r1["chain_hash"], r1["parent_hash"], r1["depth"]) == (
            r2["chain_hash"], r2["parent_hash"], r2["depth"])
        p1, p2 = r1["payload"], r2["payload"]
        assert p1[0] == p2[0]
        if p1[0] == "fp":
            assert torch.equal(p1[1], p2[1])
        else:
            for (q1, s1), (q2, s2) in zip(p1[1], p2[1]):
                assert torch.equal(q1, q2) and torch.equal(s1, s2)


def test_spill_store_refuses_another_layout(weights, tmp_path):
    eng = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_SPILL_CASES["fp"]),
                        clock=fake_clock(), device="cpu")
    eng.constrain_pool(_CONSTRAIN)
    _run_waves(eng, Request, _alternating_waves()[:2])
    assert eng.save_spill_store(str(tmp_path / "s.pkl")) > 0
    other = ServingEngine(port_model(weights[1]),
                          ServingConfig(**_SPILL_CASES["int8"]),
                          clock=fake_clock(), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        other.load_spill_store(str(tmp_path / "s.pkl"))
    with pytest.raises(RuntimeError, match="in flight"):
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
        eng.constrain_pool(4)


def test_prefix_match_len_and_engine_fences(weights):
    waves = _prefix_waves()
    eng = ServingEngine(port_model(weights[1]), ServingConfig(**_BASE),
                        clock=fake_clock(), device="cpu")
    assert eng.prefix_match_len(waves[0][0]) == 0
    _run_waves(eng, Request, waves[:1])
    assert eng.prefix_match_len(waves[0][0]) == 16
    assert eng.suffix_bucket_of(3) == 4 and eng.suffix_bucket_of(5) == 8
    for bad, exc, match in (
        (dict(suffix_buckets=(8,)), ValueError, "duplicate"),
        (dict(prefix_cache=False), ValueError, "suffix_buckets"),
        (dict(spill_blocks=4, spill_codec="int8", kv_quant="int8"),
         ValueError, "ALREADY int8"),
        (dict(prefix_cache=False, suffix_buckets=(), spill_blocks=4),
         ValueError, "host tier"),
        (dict(prefix_cache=False, suffix_buckets=(), role="decode"),
         ValueError, "handoff ledger"),
        (dict(role="prefill", speculation="ngram:2"), ValueError,
         "DECODE-side"),
    ):
        with pytest.raises(exc, match=match):
            ServingEngine(port_model(weights[1]),
                          dataclasses.replace(ServingConfig(**_BASE), **bad),
                          device="cpu")
