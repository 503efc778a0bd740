"""The port's speculation, prefill/decode roles, int8 weights, static
batching and serving telemetry against the JAX package's live engine.

The tiny GPT-2 of ``tests/torch_serving.py`` serves the same traces through
the JAX engine and the port's on the CPU; each JAX configuration is built
and run once per module (``_jax``). Greedy tokens must be identical per
request:

- ``ngram:2`` and ``ngram:4`` on the 'reference' read path (JAX's fence):
  tokens, verify calls and accepted-draft counts equal, tokens equal to
  speculation off, and the ``spec_accept`` histogram's buckets equal;
- a prefill-role engine handing every request to a decode-role engine in
  the same process: decode tokens and the handoff ledgers equal, and each
  exported block's KV equal to JAX's by value;
- ``quant='int8'``: each leaf's codes and scales equal JAX's
  ``quantize_params`` bit for bit, tokens equal, and equal to an fp engine
  loaded with the dequantized weights;
- ``static_batching``: tokens and the event stream equal, JAX's four
  fences kept;
- the telemetry bundle: JAX's span, histogram, gauge and program names on
  one served trace, and ``cli serve`` with ``telemetry.enabled=true``.
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.config import ServingConfig as JaxServing
from distributeddeeplearning_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxEngine,
)
from distributeddeeplearning_tpu.serving.quant import (
    QuantizedLeaf as JaxQuantizedLeaf,
    quantization_error,
    quantize_params as jax_quantize_params,
)
from distributeddeeplearning_tpu.telemetry import Telemetry as JaxTelemetry
from distributeddeeplearning_tpu_torch import cli
from distributeddeeplearning_tpu_torch.config import ServingConfig
from distributeddeeplearning_tpu_torch.serving import Request, ServingEngine
from distributeddeeplearning_tpu_torch.serving.quant import (
    dequantize_params,
    quantize_params,
    quantized_leaves,
    resident_param_bytes,
)
from distributeddeeplearning_tpu_torch.telemetry import (
    SPEC_ACCEPT_HIST,
    Telemetry,
    validate_chrome_trace,
)
from torch_serving import (
    assert_blocks_close,
    fake_clock,
    jax_block,
    jax_weights,
    port_block,
    port_model,
    prompts,
)

torch.set_num_threads(2)

_BASE = dict(slots=3, block_size=8, hbm_budget_mb=8, max_seq_len=48,
             prompt_buckets=(8, 16))
_SPEC = dict(_BASE, attn_kernel="reference", gauge_every=1)
_ROLES = dict(_BASE, prefix_cache=True, suffix_buckets=(4,))
_MAX_NEW = 11
_CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"


@pytest.fixture(scope="module")
def weights():
    return jax_weights()


def _trace():
    return prompts((5, 9, 3, 12, 7))


def _role_prompts():
    rng = np.random.default_rng(3)
    prefix = list(map(int, rng.integers(1, 97, 8)))
    out = [prefix + list(map(int, rng.integers(1, 97, 2 + i % 5)))
           for i in range(6)]
    return out + [list(out[0])]


def _serve(eng, req_cls, trace, **kw):
    for i, p in enumerate(trace):
        eng.submit(req_cls(prompt=list(p), max_new_tokens=_MAX_NEW,
                           request_id=i, **kw))
    return {s.request.request_id: list(s.generated) for s in eng.run()}


def _handoff(pre, dec, req_cls, trace):
    """Prefill every request on ``pre``, hand each off to ``dec`` (adopt
    its chain, then submit), and drain ``dec``."""
    for i, p in enumerate(trace):
        pre.submit(req_cls(prompt=list(p), max_new_tokens=_MAX_NEW,
                           request_id=i))
    assert pre.run() == []
    handoffs = pre.take_handoffs()
    for h in handoffs:
        req = h["request"]
        dec.adopt_chain(req.prompt, h["payloads"])
        dec.submit(req_cls(prompt=list(req.prompt), max_new_tokens=_MAX_NEW,
                           request_id=req.request_id))
    return handoffs, {s.request.request_id: list(s.generated)
                      for s in dec.run()}


_JAX: dict = {}


def _jax(weights, name, tmp_path_factory):
    """Each JAX configuration's run, once per module."""
    if name in _JAX:
        return _JAX[name]
    jm, params = weights
    if name.startswith("ngram"):
        tel = JaxTelemetry(enabled=True, out_dir=str(
            tmp_path_factory.mktemp("jax_tel")), ring_size=1 << 14)
        eng = JaxEngine(jm, params, JaxServing(
            **_SPEC, speculation=f"ngram:{name[-1]}"),
            clock=fake_clock(), telemetry=tel)
        out = {"tokens": _serve(eng, JaxRequest, _trace()), "eng": eng,
               "tel": tel}
    elif name == "roles":
        pre = JaxEngine(jm, params, JaxServing(**_ROLES, role="prefill"),
                        clock=fake_clock())
        dec = JaxEngine(jm, params, JaxServing(**_ROLES, role="decode"),
                        clock=fake_clock())
        handoffs, got = _handoff(pre, dec, JaxRequest, _role_prompts())
        out = {"tokens": got, "pre": pre, "dec": dec, "handoffs": handoffs}
    elif name == "quant":
        eng = JaxEngine(jm, params, JaxServing(**_BASE, quant="int8"),
                        clock=fake_clock())
        out = {"tokens": _serve(eng, JaxRequest, _trace()), "eng": eng}
    else:  # static
        eng = JaxEngine(jm, params, JaxServing(**_BASE), clock=fake_clock(),
                        static_batching=True)
        out = {"tokens": _serve(eng, JaxRequest, _trace()), "eng": eng}
    _JAX[name] = out
    return out


# ---------------------------------------------------------------------------
# speculation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_speculation_matches_jax(weights, tmp_path_factory, k):
    want = _jax(weights, f"ngram{k}", tmp_path_factory)
    eng = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_SPEC, speculation=f"ngram:{k}"),
                        clock=fake_clock(), device="cpu")
    got = _serve(eng, Request, _trace())
    assert got == want["tokens"]
    jeng = want["eng"]
    assert eng.calls["verify"] > 0 and eng.spec["draft_hits"] > 0
    assert eng.calls == jeng.calls
    assert eng.spec == jeng.spec
    assert eng.stats()["speculation"] == jeng.stats()["speculation"]
    assert eng.scheduler.stats() == jeng.scheduler.stats()
    plain = ServingEngine(port_model(weights[1]), ServingConfig(**_BASE),
                          clock=fake_clock(), device="cpu")
    assert _serve(plain, Request, _trace()) == got


def test_speculation_fences(weights):
    with pytest.raises(NotImplementedError, match="attn_kernel='pallas'"):
        ServingEngine(port_model(weights[1]), ServingConfig(
            **dict(_SPEC, attn_kernel="pallas"), speculation="ngram:2"),
            device="cpu")
    with pytest.raises(NotImplementedError, match="block_size"):
        ServingEngine(port_model(weights[1]), ServingConfig(
            **_SPEC, speculation="ngram:8"), device="cpu")
    eng = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_SPEC, speculation="ngram:2"),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="greedy-only"):
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=2,
                           temperature=0.7))


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def _names(tel):
    return {
        "spans": sorted({s.name for s in tel.tracer.spans}),
        "span_args": sorted({(s.name, a) for s in tel.tracer.spans
                             for a in s.args}),
        "hists": sorted(tel.hists),
        "gauges": sorted(tel._gauge_last),
        "programs": sorted(tel.registry.to_dict()["executables"]),
        "events": sorted({e.get("event") for e in tel.events}),
    }


def test_telemetry_bundle_has_jax_names(weights, tmp_path_factory, tmp_path):
    want = _jax(weights, "ngram2", tmp_path_factory)
    tel = Telemetry(enabled=True, out_dir=str(tmp_path), ring_size=1 << 14)
    eng = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_SPEC, speculation="ngram:2"),
                        clock=fake_clock(), telemetry=tel, device="cpu")
    _serve(eng, Request, _trace())
    assert _names(tel) == _names(want["tel"])
    assert SPEC_ACCEPT_HIST in tel.hists
    h, jh = tel.hists[SPEC_ACCEPT_HIST], want["tel"].hists[SPEC_ACCEPT_HIST]
    assert h.count == eng.spec["lane_steps"] > 0
    assert h.counts == jh.counts
    for reg in tel.registry.to_dict()["executables"].values():
        assert reg["recompiles"] == 0
    tel.write_trace()
    with open(tel.trace_path) as f:
        assert validate_chrome_trace(json.load(f)) == []
    stats = json.load(open(tel.stats_path))
    assert SPEC_ACCEPT_HIST in stats["histograms"]


def test_cli_serve_writes_the_telemetry_bundle(tmp_path):
    tdir = tmp_path / "tel"
    argv = ["serve", "--config", _CONFIG, "--device", "cpu",
            "--prompt", "hello", "--prompt", "hello there",
            "--max-new-tokens", "5"]
    for o in ("model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
              "model.kwargs.max_len=64", "model.kwargs.attn_impl=xla",
              "serving.prompt_buckets=(16,32)", "serving.attn_kernel=pallas",
              "serving.prefix_cache=true", "serving.spill_blocks=8",
              "serving.quant=int8", "telemetry.enabled=true",
              f"telemetry.dir={tdir}"):
        argv += ["--override", o]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(argv) == 0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rec["telemetry_dir"] == str(tdir)
    assert {"serving_decode", "serving_prefill_16"} <= set(
        rec["telemetry"]["executables"])
    assert rec["stats"]["quant"]["ratio"] < 0.5
    assert all(r["new_tokens"] == 5 for r in rec["results"])
    files = set(os.listdir(tdir))
    assert {"trace_p0_a0.json", "spans_p0_a0.jsonl",
            "stats_p0_a0.json"} <= files
    with pytest.raises(NotImplementedError, match="greedy-only"):
        cli.main(argv + ["--override", "serving.speculation=ngram:2",
                         "--override", "serving.attn_kernel=reference",
                         "--temperature", "0.5"])


# ---------------------------------------------------------------------------
# prefill/decode roles
# ---------------------------------------------------------------------------


def test_role_handoff_matches_jax(weights, tmp_path_factory):
    want = _jax(weights, "roles", tmp_path_factory)
    model = port_model(weights[1])
    pre = ServingEngine(model, ServingConfig(**_ROLES, role="prefill",
                                             attn_kernel="pallas"),
                        clock=fake_clock(), device="cpu")
    dec = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_ROLES, role="decode",
                                      attn_kernel="pallas"),
                        clock=fake_clock(), device="cpu")
    handoffs, got = _handoff(pre, dec, Request, _role_prompts())
    assert got == want["tokens"]
    assert pre.stats()["handoff"] == want["pre"].stats()["handoff"]
    assert dec.stats()["handoff"] == want["dec"].stats()["handoff"]
    assert dec.stats()["handoff"]["adopt_skipped_blocks"] > 0
    assert dec.scheduler.stats() == want["dec"].scheduler.stats()
    assert pre.scheduler.stats() == want["pre"].scheduler.stats()
    for h, jh in zip(handoffs, want["handoffs"]):
        assert h["digests"] == jh["digests"]
        for raw, jraw in zip(h["payloads"], jh["payloads"]):
            assert_blocks_close(port_block(pre, raw),
                                jax_block(want["pre"], jraw))
    unified = ServingEngine(model, ServingConfig(**_ROLES),
                            clock=fake_clock(), device="cpu")
    assert _serve(unified, Request, _role_prompts()) == got


def test_adopt_chain_dedupes_and_refuses_other_layouts(weights):
    pre = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_ROLES, role="prefill"),
                        clock=fake_clock(), device="cpu")
    p = _role_prompts()[2]
    pre.submit(Request(prompt=p, max_new_tokens=3))
    pre.run()
    (h,) = pre.take_handoffs()
    dec = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_ROLES, role="decode"),
                        clock=fake_clock(), device="cpu")
    assert dec.adopt_chain(p, h["payloads"]) == len(h["payloads"]) == 1
    assert dec.adopt_chain(p, h["payloads"]) == 0  # already held
    assert dec.stats()["handoff"]["adopt_skipped_blocks"] == 1
    q8 = ServingEngine(port_model(weights[1]),
                       ServingConfig(**_ROLES, role="decode", kv_quant="int8"),
                       clock=fake_clock(), device="cpu")
    with pytest.raises(ValueError, match="layout differs"):
        q8.adopt_chain(p, h["payloads"])
    with pytest.raises(ValueError, match="overrun"):
        dec.adopt_chain(p[:4], h["payloads"])


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------


def test_quantized_leaves_equal_jax_bit_for_bit(weights):
    _, params = weights
    tree, report = jax_quantize_params(params, 256)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda n: isinstance(n, JaxQuantizedLeaf))[0]:
        if isinstance(leaf, JaxQuantizedLeaf):
            want[".".join(p.key for p in path)] = leaf
    model = port_model(params)
    got_report = quantize_params(model, 256)
    got = quantized_leaves(model)
    assert sorted(got) == sorted(want) and got
    for name, ql in got.items():
        assert np.array_equal(ql.q.numpy(), np.asarray(want[name].q)), name
        assert np.array_equal(ql.scale.numpy(),
                              np.asarray(want[name].scale)), name
        assert ql.shape == want[name].shape and ql.size == want[name].size
    for key in ("param_bytes_fp", "param_bytes_quant", "ratio"):
        assert got_report[key] == report[key]
    assert got_report["max_rel_error"] == pytest.approx(
        quantization_error(params, 256), abs=1e-6)
    assert not [n for n, p in model.named_parameters()
                if p.dim() >= 2 and p.numel() >= 256]
    assert resident_param_bytes(model) == report["param_bytes_quant"]


def test_int8_weights_serve_as_jax(weights, tmp_path_factory):
    want = _jax(weights, "quant", tmp_path_factory)
    eng = ServingEngine(port_model(weights[1]),
                        ServingConfig(**_BASE, quant="int8",
                                      attn_kernel="pallas"),
                        clock=fake_clock(), device="cpu")
    got = _serve(eng, Request, _trace())
    assert got == want["tokens"]
    assert eng.stats()["quant"]["ratio"] == want["eng"].stats()["quant"][
        "ratio"]
    fp = port_model(weights[1])
    fp.load_state_dict(dequantize_params(eng.model), strict=True)
    plain = ServingEngine(fp, ServingConfig(**_BASE, attn_kernel="pallas"),
                          clock=fake_clock(), device="cpu")
    assert _serve(plain, Request, _trace()) == got


# ---------------------------------------------------------------------------
# static batching
# ---------------------------------------------------------------------------


def test_static_batching_matches_jax(weights, tmp_path_factory):
    want = _jax(weights, "static", tmp_path_factory)
    eng = ServingEngine(port_model(weights[1]), ServingConfig(**_BASE),
                        clock=fake_clock(), device="cpu",
                        static_batching=True)
    assert _serve(eng, Request, _trace()) == want["tokens"]
    assert [(e["event"], e.get("request_id"), e["step"])
            for e in eng.events] == [
        (e["event"], e.get("request_id"), e["step"])
        for e in want["eng"].events]
    assert eng.calls["decode"] == want["eng"].calls["decode"]


@pytest.mark.parametrize("knob", ["role", "kv_quant", "spill_blocks",
                                  "prefix_cache"])
def test_static_batching_fences(weights, knob):
    over = {"role": dict(prefix_cache=True, role="decode"),
            "kv_quant": dict(kv_quant="int8"),
            "spill_blocks": dict(prefix_cache=True, spill_blocks=4),
            "prefix_cache": dict(prefix_cache=True)}[knob]
    cfg = dataclasses.replace(ServingConfig(**_BASE), **over)
    with pytest.raises(NotImplementedError,
                       match=f"serving.{knob}.*static_batching"):
        ServingEngine(port_model(weights[1]), cfg, device="cpu",
                      static_batching=True)
    with pytest.raises(NotImplementedError, match="static_batching"):
        JaxEngine(weights[0], weights[1],
                  dataclasses.replace(JaxServing(**_BASE), **over),
                  static_batching=True)
