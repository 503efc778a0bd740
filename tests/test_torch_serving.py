"""The port's serving engine, scheduler and ``cli serve`` against the JAX
package's.

The 5-request trace of tests/test_serving.py (3 lanes, so lanes retire and
refill mid-flight; prompts span both buckets) runs through the JAX engine
and the port's engine on the CPU with the same tiny GPT-2 weights, under
that file's Pallas config (block_size 8, ``attn_kernel='pallas'``): greedy
tokens must be identical per request, with the fp and the int8 KV pool.
The scheduler replays traces through both packages' schedulers, one of
them through the prefix trie, its host tier and a chain handoff. The
serving features are held in ``tests/test_torch_serving_cache.py`` and
``tests/test_torch_serving_features.py``.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import models as jax_models
from distributeddeeplearning_tpu.config import ServingConfig as JaxServing
from distributeddeeplearning_tpu.serving import (
    KVBlockPool as JaxPool,
    Request as JaxRequest,
    Scheduler as JaxScheduler,
    ServingEngine as JaxEngine,
)
from distributeddeeplearning_tpu_torch import cli, models
from distributeddeeplearning_tpu_torch.config import (
    Config,
    ModelConfig,
    ServingConfig,
)
from distributeddeeplearning_tpu_torch.serving import (
    KVBlockPool,
    Request,
    Scheduler,
    ServingEngine,
    check_serving_composition,
)
from distributeddeeplearning_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

_PALLAS = dict(slots=3, block_size=8, hbm_budget_mb=8, max_seq_len=48,
               prompt_buckets=(8, 16), attn_kernel="pallas")
_KW = dict(size="tiny", vocab_size=97, max_len=64)
_CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    return clock


def _prompts(lens, seed=42):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 97, n))) for n in lens]


@pytest.fixture(scope="module")
def weights():
    jm = jax_models.get_model("gpt2", **_KW)
    params = jm.init(jax.random.PRNGKey(7), np.zeros((1, 8), np.int32))
    return jm, jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))


def _port_model(params):
    tm = models.get_model("gpt2", **_KW)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return tm


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_greedy_tokens_match_jax_engine(weights, kv_quant):
    jm, params = weights
    prompts = _prompts((5, 9, 3, 12, 7))
    jeng = JaxEngine(jm, params, JaxServing(kv_quant=kv_quant, **_PALLAS),
                     clock=_fake_clock())
    teng = ServingEngine(_port_model(params),
                         ServingConfig(kv_quant=kv_quant, **_PALLAS),
                         clock=_fake_clock(), device="cpu")
    for p in prompts:
        jeng.submit(JaxRequest(prompt=p, max_new_tokens=11))
        teng.submit(Request(prompt=p, max_new_tokens=11))
    jdone, tdone = jeng.run(), teng.run()
    assert len(tdone) == len(prompts)
    for i, (j, t) in enumerate(zip(jdone, tdone)):
        assert t.generated == j.generated, f"request {i}"
        assert t.slot == j.slot
    assert teng.scheduler.stats() == jeng.scheduler.stats()
    assert teng.calls["decode"] == jeng.calls["decode"]
    assert [e["event"] for e in teng.events] == [
        e["event"] for e in jeng.events
    ]


def test_scheduler_replays_jax_trace_to_the_same_state():
    def drive(pool_cls, sched_cls, req_cls):
        sched = sched_cls(3, pool_cls(16, 4), 40)
        buckets = (8, 16)

        def bucket_of(n):
            return next(b for b in buckets if n >= 0 and n <= b)

        log = []
        for i, (n, new) in enumerate([(5, 4), (9, 20), (3, 2), (12, 6),
                                      (16, 9), (1, 1)]):
            sched.submit(req_cls(prompt=[1] * n, max_new_tokens=new),
                         float(i))
        for step in range(6):
            for st in sched.admit(10.0 + step, bucket_of):
                log.append(("admit", st.request.request_id, st.slot,
                            tuple(st.blocks)))
            if step % 2:
                for st in list(sched.active)[:1]:
                    log.append(("done", st.request.request_id))
                    sched.complete(st.slot, 20.0 + step)
        return log, sched.stats(), sched.gauges(30.0)

    assert drive(KVBlockPool, Scheduler, Request) == drive(
        JaxPool, JaxScheduler, JaxRequest
    )


def _pool_state(pool):
    """Everything a pool holds: free list, owned blocks, every trie node
    (both tiers) with its chain, refcount and children, the host ledger."""
    return (
        list(pool._free), sorted(pool._allocated),
        sorted((b, nd.chain_hash, nd.parent, nd.refs, nd.last_use,
                sorted(nd.children), nd.depth)
               for b, nd in pool._cached.items()),
        pool.spilled_blocks, pool.evictable_blocks, pool.high_water,
    )


def _drive_trie(mod, tmp):
    """Three prefixes over a 10-block pool with a 3-block host tier: cold
    admissions, partial and full-prefix hits, evictions that spill,
    promotions back, a spill cap that evicts for good, generated blocks
    published at completion, a prefill-role retirement, a chain exported
    and adopted into a second pool, and the host tier saved and loaded.
    ``mod`` holds one package's pool, scheduler and digests."""
    store, log = {}, []

    def spill_fn(pairs):
        log.append(("spill", [b for b, _ in pairs]))
        store.update({h: b for b, h in pairs})

    def drop_fn(h):
        log.append(("drop", store.pop(h, None)))

    def pool_of():
        return mod["pool"](10, 4, prefix_cache=True, spill_blocks=3,
                           spill_fn=spill_fn, drop_fn=drop_fn)

    pool = pool_of()
    sched = mod["sched"](2, pool, 40, role="unified")
    widths = (4, 8, 16)

    def width(n):
        return next(b for b in widths if n <= b)

    rng = np.random.default_rng(0)
    pa, pb, pc = (list(map(int, rng.integers(1, 90, 8))) for _ in range(3))
    waves = [[pa + [1, 2], pa + [3]], [pb + [4, 5, 6]], [pc + [7]],
             [pa + [1, 2, 8], pa + [1]], [pb + [4, 5, 6]], [pa + [3]]]
    now = 0.0
    for w, wave in enumerate(waves):
        for p in wave:
            sched.submit(mod["req"](prompt=p, max_new_tokens=5), now)
        while not sched.idle:
            now += 1.0
            for st in sched.admit(now, width, suffix_bucket_of=width,
                                  cover_tokens=48):
                log.append(("admit", st.request.request_id, st.slot,
                            tuple(st.cached_blocks), tuple(st.blocks),
                            st.cached_len, st.decode_route,
                            tuple(st.promoted), st.bucket))
                sched.publish_prefix(st, len(st.request.prompt))
            for st in list(sched.active):
                st.generated = [50 + w] * 5
                if w == 2:  # the prefill role's retirement
                    sched.complete_handoff(st.slot, now,
                                           written=len(st.request.prompt))
                else:
                    sched.complete(st.slot, now)
        log.append(("wave", w, _pool_state(pool), sched.stats(),
                    sched.gauges(now), round(sched.prefix_hit_rate(), 9)))
    for p in (pa + [1, 2], pb + [4, 5, 6, 9], pc):
        digests, ids = pool.export_chain(p)
        log.append(("export", digests, ids, pool.match_len(p),
                    pool.match_digests(digests)))
    adopter = pool_of()
    digests, ids = pool.export_chain(pa + [1, 2, 8, 9])
    blocks = adopter.alloc(len(ids))
    log.append(("adopt", adopter.adopt_chain(pa + [1, 2, 8, 9], blocks),
                adopter.match_digests(digests), _pool_state(adopter)))
    path = str(tmp / f"host_{mod['name']}.pkl")
    log.append(("save", pool.save_host_store(path, store, meta={"m": 1})))
    fresh = pool_of()
    loaded = fresh.load_host_store(path, expect_meta={"m": 1})
    log.append(("load", sorted(loaded.items()), _pool_state(fresh)))
    return log


def test_scheduler_replays_a_trie_trace_to_the_same_state(tmp_path):
    from distributeddeeplearning_tpu.serving.scheduler import (
        Scheduler as JaxSched,
    )

    got = _drive_trie({"pool": KVBlockPool, "sched": Scheduler,
                       "req": Request, "name": "port"}, tmp_path)
    want = _drive_trie({"pool": JaxPool, "sched": JaxSched,
                        "req": JaxRequest, "name": "jax"}, tmp_path)
    assert got == want
    kinds = {e[0] for e in got}
    assert {"spill", "drop", "export", "adopt", "save",
            "load"} <= kinds
    admits = [e for e in got if e[0] == "admit"]
    assert any(e[6] for e in admits), "no full-prefix (decode route) hit"
    assert any(e[7] for e in admits), "no promotion from the host tier"
    assert any(e[5] and not e[6] for e in admits), "no partial hit"


def test_sampled_request_is_independent_of_batchmates(weights):
    _, params = weights
    model = _port_model(params)
    cfg = ServingConfig(**_PALLAS)

    def run(batchmates):
        eng = ServingEngine(model, cfg, clock=_fake_clock(), seed=3,
                            device="cpu")
        st = eng.submit(Request(prompt=_prompts((6,))[0], max_new_tokens=8,
                                temperature=0.9, top_k=20, request_id=0))
        for i, p in enumerate(_prompts(batchmates, seed=9)):
            eng.submit(Request(prompt=p, max_new_tokens=5, temperature=1.0,
                               request_id=i + 1))
        eng.run()
        return st.generated

    alone = run(())
    assert run((4, 11)) == alone
    assert len(alone) == 8 and all(0 <= t < 97 for t in alone)


def test_cli_serve_on_cpu_prints_the_record():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([
            "serve", "--config", _CONFIG, "--device", "cpu",
            "--override", "model.kwargs.size=tiny",
            "--override", "model.kwargs.vocab_size=256",
            "--override", "model.kwargs.max_len=64",
            "--override", "model.kwargs.attn_impl=xla",
            "--override", "serving.prompt_buckets=(16,32)",
            "--override", "serving.attn_kernel=pallas",
            "--prompt", "hello", "--prompt", "paged attention",
            "--max-new-tokens", "6",
        ])
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("no checkpoint found")
    rec = json.loads(lines[-1])
    assert [r["prompt"] for r in rec["results"]] == ["hello",
                                                     "paged attention"]
    assert all(r["new_tokens"] == 6 for r in rec["results"])
    assert rec["stats"]["attn_kernel"] == "pallas"
    assert rec["stats"]["device"] == "cpu"
    assert rec["stats"]["used_blocks"] == 0


def _serve_cfg(**serving):
    return Config(
        model=ModelConfig(name="gpt2", kwargs=dict(_KW)),
        serving=dataclasses.replace(ServingConfig(**_PALLAS), **serving),
    )


# JAX's fences of the fleet's knobs: (serving overrides, fleet size, the
# exception, its message). Each holds on the port and on the JAX package's
# own check of the same config, with the same message.
_FLEET_FENCES = {
    "replicas_below_one": (dict(replicas=0), 0, ValueError,
                           "serving.replicas must be >= 1"),
    "prefill_replicas_in_process": (
        dict(prefix_cache=True, prefill_replicas=1), 0, ValueError,
        "prefill_replicas=1 x in-process serve"),
    "prefill_replicas_whole_fleet": (
        dict(prefix_cache=True, prefill_replicas=2), 2, ValueError,
        "needs at least one decode replica"),
    "prefill_replicas_without_cache": (
        dict(prefill_replicas=1), 2, ValueError,
        "prefill_replicas=1 x prefix_cache=False"),
}


def _jax_serve_cfg(**serving):
    from distributeddeeplearning_tpu.config import (
        Config as JaxConfig,
        ModelConfig as JaxModelConfig,
    )

    return JaxConfig(
        model=JaxModelConfig(name="gpt2", kwargs=dict(_KW)),
        serving=dataclasses.replace(JaxServing(**_PALLAS), **serving),
    )


def _same_refusal(check, jax_check, exc, match):
    with pytest.raises(exc, match=match) as ours:
        check()
    with pytest.raises(exc) as theirs:
        jax_check()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("case", sorted(_FLEET_FENCES))
def test_fleet_fences_are_jax_fences(case):
    from distributeddeeplearning_tpu.serving import (
        check_serving_composition as jax_check,
    )

    serving, fleet, exc, match = _FLEET_FENCES[case]
    _same_refusal(
        lambda: check_serving_composition(_serve_cfg(**serving), fleet=fleet),
        lambda: jax_check(_jax_serve_cfg(**serving), fleet=fleet),
        exc, match)


@pytest.mark.parametrize("case,serving,exc,match", [
    ("port", dict(worker_port=65535), ValueError, "overflows"),
    ("heartbeat", dict(heartbeat_interval_s=0.5, heartbeat_timeout_s=0.4),
     ValueError, "must exceed"),
    ("static_batching", {}, NotImplementedError, "static_batching"),
])
def test_fleet_composition_fences_are_jax_fences(case, serving, exc, match):
    from distributeddeeplearning_tpu.serving.worker import (
        check_fleet_composition as jax_check,
    )
    from distributeddeeplearning_tpu_torch.serving.worker import (
        check_fleet_composition,
    )

    static = case == "static_batching"
    _same_refusal(
        lambda: check_fleet_composition(
            _serve_cfg(**serving).serving, 2, static_batching=static),
        lambda: jax_check(_jax_serve_cfg(**serving).serving, 2,
                          static_batching=static),
        exc, match)


def test_fleet_configs_pass_the_fences():
    """What the fences accept: replicas behind a router, and a role-split
    fleet of workers, on the port as on JAX."""
    from distributeddeeplearning_tpu.serving import (
        check_serving_composition as jax_check,
    )

    for serving, fleet in ((dict(replicas=2), 0), ({}, 2),
                           (dict(prefix_cache=True, prefill_replicas=1), 2)):
        check_serving_composition(_serve_cfg(**serving), fleet=fleet)
        jax_check(_jax_serve_cfg(**serving), fleet=fleet)


def test_cli_serve_restores_the_checkpoint(tmp_path):
    """``cli serve`` serves the latest checkpoint's weights: greedy tokens
    equal the JAX engine's on the same params, under the Pallas config. A
    directory whose only step cannot be read is an error, never a quiet
    fresh init."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.ops.fused_adamw import FusedAdamW
    from distributeddeeplearning_tpu_torch.train import TrainState

    kw = dict(_KW, vocab_size=256)
    jm = jax_models.get_model("gpt2", **kw)
    params = jax.tree.map(np.asarray, nn.meta.unbox(jm.init(
        jax.random.PRNGKey(3), np.zeros((1, 8), np.int32))["params"]))
    model = models.get_model("gpt2", **kw)
    model.load_state_dict(from_jax_params(params), strict=True)
    pdict = dict(model.named_parameters())
    with CheckpointManager(str(tmp_path / "ok")) as ckpt:
        ckpt.save(3, TrainState(step=3, params=pdict, rng=0,
                                opt_state=FusedAdamW(1e-3).init(pdict)))
    (tmp_path / "bad" / "100").mkdir(parents=True)

    def serve(directory):
        argv = ["serve", "--config", _CONFIG, "--device", "cpu",
                "--prompt", "hello", "--prompt", "paged attention",
                "--max-new-tokens", "7"]
        for o in (f"model.kwargs.size={kw['size']}",
                  "model.kwargs.vocab_size=256",
                  f"model.kwargs.max_len={kw['max_len']}",
                  "model.kwargs.attn_impl=xla", "model.kwargs.dtype=float32",
                  "model.kwargs.chunked_head=False",
                  f"serving.prompt_buckets={_PALLAS['prompt_buckets']}",
                  f"serving.block_size={_PALLAS['block_size']}",
                  "serving.attn_kernel=pallas",
                  f"train.checkpoint_dir={directory}"):
            argv += ["--override", o]
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(argv) == 0
        return buf.getvalue().strip().splitlines()

    lines = serve(tmp_path / "ok")
    assert lines[0] == "serving from checkpoint at step 3"
    rec = json.loads(lines[-1])
    assert rec["step"] == 3
    jeng = JaxEngine(jm, params, JaxServing(
        prompt_buckets=_PALLAS["prompt_buckets"],
        block_size=_PALLAS["block_size"], attn_kernel="pallas"))
    for p in ("hello", "paged attention"):
        jeng.submit(JaxRequest(prompt=list(p.encode()), max_new_tokens=7))
    for r, j in zip(rec["results"], jeng.run()):
        assert r["new_tokens"] == len(j.generated) == 7
        assert r["completion"] == bytes(
            t for t in j.generated if 0 <= t < 256).decode(
            "utf-8", errors="replace")
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        serve(tmp_path / "bad")


@pytest.mark.parametrize("case,exc,match", [
    ("block_size", NotImplementedError, "multiple of 8"),
    ("flash", NotImplementedError, "attn_impl='flash'"),
    ("suffix", ValueError, "suffix_buckets"),
    ("kv_quant", ValueError, "kv_quant must be one of"),
])
def test_reference_fences_are_kept(case, exc, match):
    cfg = {
        "block_size": _serve_cfg(block_size=4),
        "flash": dataclasses.replace(_serve_cfg(), model=ModelConfig(
            name="gpt2", kwargs={"attn_impl": "flash"})),
        "suffix": _serve_cfg(suffix_buckets=(4,)),
        "kv_quant": _serve_cfg(kv_quant="fp8"),
    }[case]
    with pytest.raises(exc, match=match):
        check_serving_composition(cfg)


def test_default_device_is_the_gpu(weights):
    if torch.cuda.is_available():
        pytest.skip("asserts the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ServingEngine(_port_model(weights[1]), ServingConfig(**_PALLAS))
