"""The port's serving engine, scheduler and ``cli serve`` against the JAX
package's.

The 5-request trace of tests/test_serving.py (3 lanes, so lanes retire and
refill mid-flight; prompts span both buckets) runs through the JAX engine
and the port's engine on the CPU with the same tiny GPT-2 weights, under
that file's Pallas config (block_size 8, ``attn_kernel='pallas'``): greedy
tokens must be identical per request, with the fp and the int8 KV pool.
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
    apply_overrides,
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


_REFUSED = {
    "quant": dict(quant="int8"),
    "speculation": dict(speculation="ngram:2", attn_kernel="reference"),
    "prefix_cache": dict(prefix_cache=True),
    "spill_blocks": dict(prefix_cache=True, spill_blocks=4),
    "role": dict(prefix_cache=True, role="decode"),
    "replicas": dict(replicas=2),
}


@pytest.mark.parametrize("knob", sorted(_REFUSED))
def test_unported_knobs_are_refused_by_name(weights, knob):
    cfg = _serve_cfg(**_REFUSED[knob])
    with pytest.raises(NotImplementedError,
                       match=f"serving.{knob}.*not yet ported"):
        check_serving_composition(cfg)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ServingEngine(_port_model(weights[1]), cfg.serving, device="cpu")


@pytest.mark.parametrize("case", ["fleet", "telemetry", "static",
                                  "engine_tel"])
def test_other_unported_paths_are_refused(weights, tmp_path, case):
    cfg = _serve_cfg()
    if case == "fleet":
        with pytest.raises(NotImplementedError, match="--fleet 2 not yet"):
            check_serving_composition(cfg, fleet=2)
    elif case == "telemetry":
        cfg = apply_overrides(cfg, ["telemetry.enabled=true"])
        with pytest.raises(NotImplementedError, match="telemetry"):
            check_serving_composition(cfg)
    else:
        kw = ({"static_batching": True} if case == "static"
              else {"telemetry": object()})
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ServingEngine(_port_model(weights[1]), cfg.serving,
                          device="cpu", **kw)


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
