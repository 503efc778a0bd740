"""CLI entry points: ``python -m distributeddeeplearning_tpu_torch.cli
{train,eval,benchmark,generate,serve}``.

``train`` runs the training path (``build_all`` -> ``Trainer`` -> ``fit``)
on one rank, or on every rank ``torchrun`` starts (one process per rank,
``mesh.dp`` x ``mesh.fsdp`` x ``mesh.pp`` x ``mesh.tp`` x ``mesh.cp`` x
``mesh.ep`` of them), resuming from ``train.checkpoint_dir``;
``eval`` evaluates its latest checkpoint; ``benchmark`` times the config's
training step (``benchmark.run_benchmark``: images or tokens per second per
GPU); ``generate`` samples from its latest checkpoint's weights with the
KV-cache decoder (``generate.py``); ``serve`` runs the in-process serving
engine on them. All run on the GPU by default; ``--device cpu`` asks for the
CPU (and gloo under ``torchrun``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import sys

import torch

from . import models, resolve_device
from .config import Config, apply_overrides, load_config


def build_model(cfg: Config, device):
    """The config's model with weights drawn from ``train.seed``."""
    model = models.get_model(cfg.model.name, **cfg.model.kwargs)
    gen = torch.Generator().manual_seed(int(cfg.train.seed))
    model.init_weights(gen)
    return model.to(device)


def _mesh_sizes(cfg: Config, world_size: int) -> dict[str, int]:
    """The mesh's axis sizes over ``world_size`` ranks; where they do not
    fit the ranks, -1 counts as 1 (``build_mesh`` then says why)."""
    from .mesh import MESH_AXES, axis_sizes

    try:
        return axis_sizes(cfg.mesh, world_size)
    except ValueError:
        return {a: max(getattr(cfg.mesh, a), 1) for a in MESH_AXES}


# Mesh axes whose parallel strategy is not ported: (what, ROADMAP item).
_UNPORTED_AXES = {
    "dcn_dp": ("data parallelism across slices over DCN", "A13"),
}


# (knob, value is on, what it is, ROADMAP queue item that ports it)
def _unported_train_knobs(cfg: Config, world_size: int = 1):
    t, mesh = cfg.train, cfg.mesh
    sizes = {**_mesh_sizes(cfg, world_size), "dcn_dp": mesh.dcn_dp}
    mesh_knobs = [
        ("mesh", dataclasses.asdict(mesh) if sizes[a] > 1 else "",
         f"mesh.{a}={sizes[a]} ({what})", item)
        for a, (what, item) in _UNPORTED_AXES.items()
    ]
    fault = t.fault_injection.partition(":")[0]
    return [
        ("telemetry.enabled", cfg.telemetry.enabled, "telemetry", "A14"),
        ("train.fault_injection", t.fault_injection
         if fault in ("step", "hang", "corrupt") else "",
         f"fault injection of kind {fault!r} (the supervisor's crash, hang "
         "and corrupt-checkpoint faults; 'nan:K' is ported)", "A14"),
        ("train.debug_nans", t.debug_nans, "NaN debugging", "A14"),
        ("train.debug_checks", t.debug_checks, "runtime checks", "A14"),
        ("train.grad_comm", t.grad_comm if t.grad_comm != "fp32" else "",
         "compressed gradient sync", "A13"),
        ("train.grad_bucket_mb", t.grad_bucket_mb,
         "bucketed overlapped gradient sync", "A13"),
        ("train.update_sharding", t.update_sharding
         if t.update_sharding == "sharded" else "",
         "sharded weight update", "A13"),
        ("train.zero1", t.zero1 and cfg.optim.name == "sgd"
         and sizes["dp"] > 1,
         "ZeRO-1 of the SGD momentum trace (optim.name='sgd'; the port "
         "shards AdamW's moments)", "A8"),
        *mesh_knobs,
    ]


def check_train_composition(cfg: Config, world_size: int = 1) -> None:
    """Refuse by name, before anything is built, every training knob whose
    feature is not ported yet, over a job of ``world_size`` ranks; and, as
    the reference's Trainer does, ``mesh.ep`` over a model without experts
    (a pipelined model's own fence names it, in the Trainer)."""
    for knob, value, what, item in _unported_train_knobs(cfg, world_size):
        if value:
            raise NotImplementedError(
                f"{knob}={value!r}: {what} not yet ported to "
                f"distributeddeeplearning_tpu_torch (ROADMAP queue {item})"
            )
    ep = _mesh_sizes(cfg, world_size)["ep"]
    name = cfg.model.name
    if ep > 1 and not (models.has_experts(name) or models.is_pipelined(name)):
        raise ValueError(
            f"mesh ep={ep} but model {name!r} has no experts: the ep axis "
            "would silently replicate — use an MoE model (gpt2_moe/"
            "llama_moe) or drop the axis")


def build_all(cfg: Config, device, mesh=None, fault_nan_step=None):
    """Construct (model, trainer, dataset) from a config on ``device``, for
    this rank of ``mesh`` (default: the one-rank mesh), which the model
    gets too (ResNet syncs its BatchNorm statistics over its dp ranks, the
    ring attention cores rotate over its cp ranks). The model's compute
    dtype follows ``train.precision.policy`` when the policy is mixed, and
    ``train.remat`` other than 'none' sets the model's per-block activation
    checkpointing, as in the reference. The trainer carries the config's
    health guard and ``fault_nan_step`` (the step whose gradients the
    ``nan:K`` fault poisons)."""
    from . import data
    from .mesh import single_device_mesh
    from .models.gpt2 import as_torch_dtype
    from .precision import check_precision_composition
    from .train import Trainer, get_task, make_optimizer

    mesh = mesh or single_device_mesh()
    policy = check_precision_composition(cfg.train.precision.policy,
                                         optim_name=cfg.optim.name)
    check_train_composition(cfg, world_size=mesh.size)
    kwargs = dict(cfg.model.kwargs)
    if policy.mixed:
        explicit = kwargs.get("dtype")
        if explicit is not None and (
                as_torch_dtype(explicit) != policy.compute_dtype):
            raise ValueError(
                f"model.kwargs.dtype={explicit!r} conflicts with "
                f"train.precision.policy={policy.name!r} (compute dtype "
                f"{policy.compute_dtype}): drop model.kwargs.dtype — the "
                "policy owns the compute dtype"
            )
        kwargs["dtype"] = policy.compute_dtype
    if cfg.train.remat != "none":
        if not models.supports_remat(cfg.model.name):
            raise ValueError(
                f"model {cfg.model.name!r} does not support remat")
        kwargs["remat"] = cfg.train.remat
    if cfg.train.sequence_parallel and mesh.shape["tp"] > 1:
        # Megatron sequence parallelism (``parallel.tp.tp_rules``): the
        # activations' seq over tp between the blocks; a no-op at tp = 1.
        kwargs["sequence_parallel"] = True
    model = models.get_model(cfg.model.name, **kwargs, mesh=mesh).to(device)
    if cfg.train.remat != "none" and getattr(model, "remat",
                                             None) != cfg.train.remat:
        raise ValueError(f"model {cfg.model.name!r} does not support remat")
    tx = make_optimizer(
        cfg.optim.name, cfg.optim.lr, momentum=cfg.optim.momentum,
        b1=cfg.optim.b1, b2=cfg.optim.b2,
        weight_decay=cfg.optim.weight_decay,
        warmup_steps=cfg.optim.warmup_steps, schedule=cfg.optim.schedule,
        total_steps=cfg.train.steps, grad_clip=cfg.optim.grad_clip,
        precision=policy,
    )
    trainer = Trainer(
        model, tx,
        get_task(cfg.train.task, mesh=mesh, head_chunk=cfg.train.head_chunk,
                 label_smoothing=cfg.train.label_smoothing),
        device=device, precision=policy, mesh=mesh, zero1=cfg.train.zero1,
        grad_accum=cfg.train.grad_accum, health=cfg.health,
        fault_nan_step=fault_nan_step,
    )
    dataset = data.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return model, trainer, dataset


def _rank_report(device, history, state, ckpt, transport=()) -> dict:
    """What one rank reports at the end: its kernel launch counts (and the
    flash kernels' folded [bh, L, D] shapes), its peak device memory, its optimizer state's bytes (Adam's moments, a shard of
    them under ZeRO-1, or SGD's trace), the losses it logged, its
    checkpoint saves' timings, and what the pipeline schedules did on it
    (``parallel.pp.TICKS``) when they ran; for a model cut over tp, fsdp or
    ep
    its params' bytes (its gradients' are the same) against the whole
    model's fp32 bytes, the sharded fractions, and the seconds inside the
    transport's calls each step (``transport``: ``comms.TRANSPORT``'s
    seconds at the end of each step)."""
    from .ops import flash_attention, fused_adamw, ring_attention_pallas
    from .parallel import pp
    from .train import opt_state_bytes

    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    opt_bytes = opt_state_bytes(state.opt_state)
    report = {
        "launches": {**flash_attention.LAUNCHES, **fused_adamw.LAUNCHES,
                     **ring_attention_pallas.LAUNCHES},
        "flash_shapes": {k: sorted(v)
                         for k, v in flash_attention.SHAPES.items()},
        "peak_mem_gb": peak,
        "opt_state_bytes": opt_bytes,
        "losses": [r["loss"] for r in history if "loss" in r],
        "checkpoints": ckpt.timings if ckpt is not None else [],
        **({"pipeline": dict(pp.TICKS)} if pp.TICKS["train_ticks"]
           else {}),
    }
    if state.shards is not None:
        from .parallel.fsdp import sharded_fraction

        report["shards"] = {
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in state.params.values()),
            "whole_param_bytes": 4 * state.shards.whole_numel(state.params),
            "sharded_fraction": {a: sharded_fraction(state.shards, a)
                                 for a in ("tp", "fsdp", "ep")},
            "transport_s_by_step": [
                b - a for a, b in zip([0.0, *transport], transport)],
        }
    return report


@contextlib.contextmanager
def _joined(cfg: Config, device):
    """This rank's (device, mesh, say) for the length of a command: under
    ``torchrun`` the rank joins the process group first and leaves it at
    the end, after every rank is done reading from the others. ``say``
    prints on rank 0 only."""
    import torch.distributed as dist

    from .comms import psum
    from .mesh import DistEnv, build_mesh, init_distributed, rank_device

    env = DistEnv.from_environ()
    device = resolve_device(device)
    joined = init_distributed(device, env)
    try:
        if joined:
            device = rank_device(device, env)
        mesh = build_mesh(cfg.mesh)

        def say(text):
            if mesh.rank == 0:
                print(text, flush=True)

        yield device, mesh, say
        if joined:  # no rank leaves while another still reads from it
            psum(torch.zeros((), device=device), mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def make_eval_fn(cfg: Config, mesh, device, dataset=None):
    """A callable returning a fresh iterable of this rank's eval-split
    batches on ``device`` (``train.eval_batches`` of them, from index 0):
    what ``fit(eval_fn=...)`` and :func:`cmd_eval` consume. ``dataset``
    reuses an eval dataset already built."""
    from . import data

    eval_ds = dataset if dataset is not None else data.make_dataset(
        cfg.data.kind, **cfg.data.eval_dataset_kwargs())

    def eval_batches():
        it = itertools.islice(eval_ds.iter_from(0), cfg.train.eval_batches)
        return data.prefetch(data.sharded_batches(it, mesh), device,
                             size=cfg.data.prefetch_size)

    return eval_batches


def _restore_or_init(cfg: Config, state, verb: str, say=print):
    """``state`` restored from the latest checkpoint of
    ``train.checkpoint_dir`` when it holds one, else as it is (freshly
    initialized): the preamble of ``eval`` and ``serve``."""
    from .checkpoint import CheckpointManager

    if cfg.train.checkpoint_dir:
        with CheckpointManager(cfg.train.checkpoint_dir) as ckpt:
            if ckpt.latest_step() is not None:
                state, _ = ckpt.restore(state)
                say(f"{verb} checkpoint at step {state.step}")
                return state
    say(f"no checkpoint found — {verb} freshly initialized params")
    return state


def cmd_train(cfg: Config, *, device=None, sync_steps: bool = False) -> int:
    """Train on this rank: one JSON record per ``train.log_every`` steps
    (and per evaluation), printed by rank 0 and appended to
    ``<train.log_dir>/metrics.jsonl``. Under ``torchrun`` every rank joins
    the process group first, and the mesh spans ``WORLD_SIZE`` ranks. With
    ``train.checkpoint_dir`` holding a checkpoint, training resumes from its
    latest step and batch index (``resumed from step N``); checkpoints are
    saved every ``train.save_every`` steps, and every save is on disk before
    the command returns, on every exit path. ``sync_steps`` ends every step
    in a device sync and prints each step's seconds, with every rank's
    report (:func:`_rank_report`), in a final ``train_end`` event record.

    With the health guard on, ``max_consecutive_anomalies`` anomalous steps
    in a row end the attempt (``train.HealthRollback``): training restarts
    from the last checkpoint (a ``rollback_restart`` record), up to
    ``health.max_rollbacks`` times, then gives up with exit code 1 (a
    ``rollback_give_up`` record on stderr). A restart models a transient
    fault, so an injected ``nan:K`` fault is disarmed for it."""
    from .mesh import DistEnv
    from .train import HealthRollback, check_fusion_cadences
    from .train import parse_fault_injection

    t = cfg.train
    check_train_composition(cfg, world_size=DistEnv.from_environ().world_size)
    fault = parse_fault_injection(t.fault_injection)
    # Cadence fences before the build: fit checks again with the resume
    # step.
    check_fusion_cadences(t.steps_per_call, steps=t.steps,
                          log_every=t.log_every, eval_every=t.eval_every,
                          save_every=t.save_every)
    with _joined(cfg, device) as (device, mesh, say):
        rollbacks = 0
        while True:
            try:
                _train_once(cfg, device, mesh, say, sync_steps,
                            fault_nan_step=fault.step if fault else None)
                return 0
            except HealthRollback as rb:
                rollbacks += 1
                if rollbacks > cfg.health.max_rollbacks:
                    if mesh.rank == 0:
                        print(json.dumps({
                            "event": "rollback_give_up",
                            "rollbacks": rollbacks - 1,
                            "max_rollbacks": cfg.health.max_rollbacks,
                            "step": rb.step,
                        }), file=sys.stderr, flush=True)
                    return 1
                say(json.dumps({
                    "event": "rollback_restart", "rollbacks": rollbacks,
                    "step": rb.step, "consecutive": rb.consecutive,
                }))
                fault = None


def _train_once(cfg: Config, device, mesh, say, sync_steps: bool,
                fault_nan_step: int | None) -> None:
    """One attempt of :func:`cmd_train` on this rank of ``mesh``: build,
    resume from the latest checkpoint if any, and fit."""
    import torch.distributed as dist

    from . import comms, data
    from .checkpoint import CheckpointManager
    from .metrics import MetricWriter, Profiler, event_record
    from .parallel import pp
    from .train import fit

    t = cfg.train
    ckpt = writer = None
    pp.reset_ticks()  # the train_end record reports this attempt's
    try:
        _, trainer, dataset = build_all(cfg, device, mesh,
                                        fault_nan_step=fault_nan_step)
        live = {a: n for a, n in mesh.shape.items() if n > 1}
        say(f"devices: {mesh.size}  device: {device}  mesh: {live or {}}")
        state = trainer.init(t.seed)
        start_index = 0
        if t.checkpoint_dir:
            ckpt = CheckpointManager(t.checkpoint_dir)
            if ckpt.latest_step() is not None:
                state, data_state = ckpt.restore(state)
                start_index = int(data_state.get("next_index", state.step))
                say(f"resumed from step {state.step}")
        whole = state.shards or state.stage_rows
        n = (whole.whole_numel(state.params) if whole is not None
             else sum(p.numel() for p in state.params.values()))
        say(f"model: {cfg.model.name}  params: {n:,}")
        placed = data.sharded_batches(dataset.iter_from(start_index), mesh,
                                      t.grad_accum)
        if t.steps_per_call > 1:
            placed = data.stacked_batches(placed, t.steps_per_call)
        batches = data.prefetch(placed, device, size=cfg.data.prefetch_size)
        writer = MetricWriter(t.log_dir)
        step_s = [] if sync_steps else None
        # The pipeline's, and the transport's, seconds at the end of each
        # step.
        transport, calls_s = [], []
        comms.reset_transport()
        state, history = fit(
            trainer, state, batches, steps=t.steps, log_every=t.log_every,
            steps_per_call=t.steps_per_call,
            log_fn=lambda m: say(json.dumps(m)), writer=writer,
            profiler=Profiler(t.profile_steps, t.log_dir), ckpt=ckpt,
            save_every=t.save_every, eval_every=t.eval_every,
            eval_fn=(make_eval_fn(cfg, mesh, device) if t.eval_every
                     else None),
            step_times=step_s,
            health=cfg.health if cfg.health.enabled else None,
            on_step=(lambda _: (
                transport.append(pp.TICKS["train_transport_s"]),
                calls_s.append(comms.TRANSPORT["seconds"])))
            if sync_steps else None)
        if ckpt is not None:
            ckpt.wait()
        if sync_steps:
            report = _rank_report(device, history, state, ckpt, calls_s)
            if "pipeline" in report:
                report["pipeline"]["transport_s_by_step"] = [
                    b - a for a, b in zip([0.0] + transport, transport)]
            extra = {k: report[k] for k in ("launches", "peak_mem_gb",
                                            "opt_state_bytes", "checkpoints")}
            if mesh.size > 1:
                extra = {"backend": dist.get_backend(),
                         "ranks": mesh.comm.gather_objects(report)}
            say(json.dumps(event_record("train_end", t.steps, step_s=step_s,
                                        **extra)))
    finally:
        # An abandoned in-flight save would quietly roll a resume back by
        # save_every steps: drain it on every exit path.
        if ckpt is not None:
            ckpt.close()
        if writer is not None:
            writer.close()


def cmd_eval(cfg: Config, *, device=None) -> int:
    """Evaluate the latest checkpoint of ``train.checkpoint_dir`` (or fresh
    weights when it holds none) over ``train.eval_batches`` eval batches;
    rank 0 prints one JSON record of the mean ``eval_*`` metrics and the
    step."""
    from .train import evaluate

    with _joined(cfg, device) as (device, mesh, say):
        _, trainer, _ = build_all(cfg, device, mesh)
        state = _restore_or_init(cfg, trainer.init(cfg.train.seed),
                                 "evaluating", say)
        metrics = evaluate(trainer, state, make_eval_fn(cfg, mesh, device)())
        say(json.dumps({**metrics, "step": state.step}))
    return 0


def cmd_benchmark(cfg: Config, *, device=None, steps: int = 30,
                  latency_steps=None, probe=None) -> int:
    """Time the config's training step on this rank (every rank under
    ``torchrun``); rank 0 prints the one-line JSON record of
    ``benchmark.run_benchmark`` at the depth given (its defaults unless
    set)."""
    from .benchmark import run_benchmark
    from .mesh import DistEnv

    check_train_composition(cfg, world_size=DistEnv.from_environ().world_size)
    with _joined(cfg, device) as (device, mesh, say):
        say(json.dumps(run_benchmark(cfg, device, mesh, steps=steps,
                                     latency_steps=latency_steps,
                                     fused_probe=probe)))
    return 0


def cmd_generate(cfg: Config, prompts: list[str], max_new_tokens: int,
                 temperature: float, seed: int, *, top_k: int = 0,
                 top_p: float = 0.0, bench: bool = False, reps: int = 3,
                 device=None) -> int:
    """Sample text from the latest checkpoint of ``train.checkpoint_dir``
    (or fresh weights) with the KV-cache decoder (``generate.py``). Byte
    tokenizer: prompts are encoded as UTF-8 bytes, completions decoded
    back. Repeating ``--prompt`` batches uneven prompts (left-padded);
    ``--bench`` times prefill and the per-token decode loop apart
    (``generate.decode_bench``, medians over ``reps`` runs) and adds its
    record. Prints one JSON
    record: the step, the bench fields, the results."""
    import inspect

    import numpy as np

    from .generate import decode_bench, pad_prompts
    from .generate import generate as run_generate
    from .train import TrainState

    # Cheap argument validation before the model build and restore.
    if temperature == 0.0 and (top_k or top_p):
        raise ValueError(
            "--top-k/--top-p only apply when sampling — set --temperature"
        )
    if any(not p for p in prompts):
        raise ValueError("prompt must be non-empty")
    if bench and max_new_tokens < 2:
        raise ValueError(
            "--bench needs --max-new-tokens >= 2 (at least one per-token "
            "decode step to time)"
        )
    if bench and reps < 3:
        raise ValueError("--bench needs --reps >= 3 for a stable median")
    device = resolve_device(device)
    model, _, _ = build_all(cfg, device)
    if "cache" not in inspect.signature(model.forward).parameters:
        raise ValueError(
            f"model {cfg.model.name!r} has no KV-cache decode support"
        )
    # Byte tokenizer only: a BPE model's ids are not bytes, so encoding
    # and decoding would be silently meaningless.
    vocab = getattr(model, "vocab_size", 0)
    if vocab != 256:
        raise ValueError(
            f"cli generate requires a byte-tokenizer model "
            f"(vocab_size=256, got {vocab}): prompts are encoded as UTF-8 "
            "bytes and completions decoded back (prepare_data "
            "--tokenizer byte). Use generate.generate() directly for "
            "other tokenizers."
        )
    model.init_weights(torch.Generator().manual_seed(int(cfg.train.seed)))
    state = _restore_or_init(
        cfg, TrainState(step=0, params=dict(model.named_parameters()),
                        opt_state=None, rng=int(cfg.train.seed),
                        model_state=dict(model.named_buffers())),
        "generating from")
    encoded = [list(p.encode("utf-8")) for p in prompts]
    tokens, lens = pad_prompts(encoded, pad_id=0)
    if tokens.shape[1] + max_new_tokens > model.max_len:
        raise ValueError(
            f"prompt ({tokens.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) exceeds model max_len {model.max_len}"
        )
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(max_new_tokens=max_new_tokens, temperature=temperature,
              top_k=top_k, top_p=top_p, generator=gen, prompt_lens=lens)
    record: dict = {"step": state.step}
    if bench:
        out, bench_rec = decode_bench(model, tokens, reps=reps, **kw)
        record.update(bench_rec)
    else:
        out = run_generate(model, tokens, **kw)
    new = out[:, tokens.shape[1]:].cpu().numpy()
    record["results"] = [
        {"prompt": p,
         "completion": bytes(int(t) for t in np.asarray(row)).decode(
             "utf-8", errors="replace")}
        for p, row in zip(prompts, new)
    ]
    print(json.dumps(record))
    return 0


def cmd_serve(cfg: Config, prompts: list[str], max_new_tokens: int,
              temperature: float, seed: int, *, top_k: int = 0,
              top_p: float = 0.0, device=None) -> int:
    """Serve a batch of prompts through the continuous-batching engine
    (byte tokenizer: prompts are UTF-8 bytes, completions decoded back).
    Prints one JSON record with completions, per-request latency metrics,
    engine stats and the lifecycle event stream."""
    from .serving import Request, ServingEngine, check_serving_composition

    # Composition fences FIRST (fail by name before any build).
    check_serving_composition(cfg)
    if any(not p for p in prompts):
        raise ValueError("prompt must be non-empty")
    if temperature == 0.0 and (top_k or top_p):
        raise ValueError(
            "--top-k/--top-p only apply when sampling — set --temperature"
        )
    vocab = cfg.model.kwargs.get("vocab_size", 50257)
    if vocab != 256:
        raise ValueError(
            f"cli serve requires a byte-tokenizer model (vocab_size=256, "
            f"got {vocab}): prompts are encoded as UTF-8 bytes and "
            "completions decoded back. Use serving.ServingEngine directly "
            "for other tokenizers."
        )
    from .train import TrainState

    device = resolve_device(device)
    model = build_model(cfg, device)
    state = _restore_or_init(
        cfg, TrainState(step=0, params=dict(model.named_parameters()),
                        opt_state=None, rng=int(cfg.train.seed)),
        "serving from")
    engine = ServingEngine(model, cfg.serving, seed=seed, device=device)
    engine.warmup()
    for p in prompts:
        engine.submit(Request(
            prompt=list(p.encode("utf-8")), max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
        ))
    finished = engine.run()
    results = []
    for st in finished:
        m = st.metrics()
        m["prompt"] = bytes(st.request.prompt).decode("utf-8", "replace")
        m["completion"] = bytes(
            t for t in st.generated if 0 <= t < 256
        ).decode("utf-8", errors="replace")
        results.append(m)
    record = {
        "step": state.step,
        "results": results,
        "stats": engine.stats(),
        "events": engine.events,
    }
    print(json.dumps(record))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="distributeddeeplearning_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--config", required=True, help="path to a config .py")
        p.add_argument(
            "--override", action="append", default=[], metavar="a.b=v",
            help="dotted config override (repeatable)",
        )
        p.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' on request)",
        )

    t = sub.add_parser("train")
    common(t)
    t.add_argument(
        "--sync-steps", action="store_true",
        help="end every step in a device sync and print the step times in "
        "a final train_end record",
    )
    e = sub.add_parser("eval")
    common(e)
    b = sub.add_parser("benchmark")
    common(b)
    b.add_argument("--steps", type=int, default=30,
                   help="timed steps after the warm-up")
    b.add_argument("--latency-steps", type=int, default=None,
                   help="steps synced one by one for p50/p90 (default "
                   "min(steps, 12))")
    b.add_argument("--probe", type=int, default=None, metavar="K",
                   help="steps per call of the multi-step probe (default "
                   "train.steps_per_call when above 1, else 8; 0 turns it "
                   "off)")

    def sampling(p, what):
        p.add_argument("--prompt", required=True, action="append",
                       help=f"repeatable: a batch of (uneven) prompts {what}")
        p.add_argument("--max-new-tokens", type=int, default=64)
        p.add_argument("--temperature", type=float, default=0.0)
        p.add_argument("--top-k", type=int, default=0)
        p.add_argument("--top-p", type=float, default=0.0)
        p.add_argument("--seed", type=int, default=0)

    g = sub.add_parser("generate")
    common(g)
    sampling(g, "decodes together, left-padded")
    g.add_argument(
        "--bench", action="store_true",
        help="time prefill and the per-token decode loop apart (>= 3 reps, "
        "medians) and report decode tokens/sec",
    )
    g.add_argument("--reps", type=int, default=3,
                   help="timed runs of each stage under --bench (>= 3)")
    p = sub.add_parser("serve")
    common(p)
    p.add_argument(
        "--telemetry", nargs="?", const="", default=None, metavar="DIR",
        help="enable telemetry (refused: not yet ported)",
    )
    sampling(p, "decodes by continuous batching over serving.slots lanes")
    p.add_argument(
        "--fleet", type=int, default=0,
        help="cross-process fleet (refused: not yet ported)",
    )
    args = parser.parse_args(argv)
    if args.cmd == "train":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_train(cfg, device=args.device, sync_steps=args.sync_steps)
    if args.cmd == "eval":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_eval(cfg, device=args.device)
    if args.cmd == "benchmark":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_benchmark(cfg, device=args.device, steps=args.steps,
                             latency_steps=args.latency_steps,
                             probe=args.probe)
    if args.cmd == "generate":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_generate(
            cfg, args.prompt, args.max_new_tokens, args.temperature,
            args.seed, top_k=args.top_k, top_p=args.top_p, bench=args.bench,
            reps=args.reps, device=args.device,
        )
    if args.telemetry is not None:
        args.override = list(args.override) + ["telemetry.enabled=True"]
        if args.telemetry:
            args.override.append(f"telemetry.dir={args.telemetry}")
    cfg = apply_overrides(load_config(args.config), args.override)
    if args.fleet:
        from .serving import check_serving_composition

        check_serving_composition(cfg, fleet=args.fleet)
    return cmd_serve(
        cfg, args.prompt, args.max_new_tokens, args.temperature, args.seed,
        top_k=args.top_k, top_p=args.top_p, device=args.device,
    )


if __name__ == "__main__":
    raise SystemExit(main())
