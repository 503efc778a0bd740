"""Config system: frozen dataclasses + dotted CLI overrides.

The schema is field-for-field the one of ``distributeddeeplearning_tpu.config``
(so the same ``--override section.field=value`` strings work against both
packages), kept as a copy here because that module imports ``mesh`` and with
it JAX. ``MeshConfig`` is a plain dataclass; ``mesh.build_mesh`` lays it
over the ranks. Each config module exposes ``get_config() -> Config``.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import sys
from typing import Any


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each named mesh axis (``-1`` absorbs the remaining
    ranks); ``mesh.axis_sizes`` resolves them. Training runs dp, fsdp,
    pp, tp and cp; ``cli train`` refuses the other axes by name."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    cp: int = 1
    ep: int = 1
    dcn_dp: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "resnet18"
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "synthetic_image"
    batch_size: int = 64
    image_size: int = 32
    channels: int = 3
    num_classes: int = 10
    seq_len: int = 128
    vocab_size: int = 1024
    mask_prob: float = 0.15
    mask_token_id: int = 3
    pad_min_len: int = 0
    n_distinct: int = 8
    seed: int = 0
    eval_seed: int = -1
    eval_path: str = ""
    path: str = ""
    num_threads: int = 2
    prefetch_depth: int = 4
    prefetch_size: int = 2
    augment: bool = False
    aug_pad: int = 4
    label_bytes: int = 1

    def dataset_kwargs(self) -> dict[str, Any]:
        """Kwargs for this kind's dataset class: the intersection of its
        dataclass fields with this config's, from the one registry in
        ``data.py``."""
        from .data import DATASET_KINDS, make_dataset

        if self.kind not in DATASET_KINDS:
            make_dataset(self.kind)  # raises, naming the kind
        names = {f.name for f in dataclasses.fields(DATASET_KINDS[self.kind])}
        return {k: getattr(self, k) for k in names if hasattr(self, k)}

    def eval_dataset_kwargs(self) -> dict[str, Any]:
        """:meth:`dataset_kwargs` on the eval split: ``eval_seed`` (when
        >= 0) in place of ``seed``, ``eval_path`` in place of a file-backed
        kind's ``path``, and never augmented (the reference's rules)."""
        kwargs = self.dataset_kwargs()
        if "augment" in kwargs:
            kwargs["augment"] = False
        if "path" in kwargs:  # file-backed kind
            if self.eval_path:
                kwargs["path"] = self.eval_path
            elif self.eval_seed >= 0:
                raise ValueError(
                    f"data.eval_seed with file-backed kind {self.kind!r} only "
                    "reshuffles the training file — set data.eval_path to a "
                    "held-out file instead"
                )
            else:
                print(
                    f"WARNING: file-backed kind {self.kind!r} has no "
                    "data.eval_path — eval_* metrics will be computed on "
                    "the TRAINING file (training loss, not held-out eval)",
                    file=sys.stderr, flush=True,
                )
            return kwargs
        if self.eval_seed >= 0 and "seed" in kwargs:
            kwargs["seed"] = self.eval_seed
        return kwargs


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "sgd"
    lr: float = 0.1
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.0
    warmup_steps: int = 0
    schedule: str = "constant"
    grad_clip: float = 0.0


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    policy: str = "fp32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    steps_per_call: int = 1
    seed: int = 0
    task: str = "classification"
    grad_accum: int = 1
    remat: str = "none"
    zero1: bool = False
    checkpoint_dir: str = ""
    save_every: int = 0
    eval_every: int = 0
    eval_batches: int = 8
    head_chunk: int = 128
    label_smoothing: float = 0.0
    sequence_parallel: bool = False
    grad_comm: str = "fp32"
    grad_comm_block: int = 256
    grad_bucket_mb: float = 0.0
    update_sharding: str = "replicated"
    comm_hierarchy: str = "auto"
    precision: PrecisionConfig = dataclasses.field(
        default_factory=PrecisionConfig
    )
    compile_cache_dir: str = ""
    log_dir: str = ""
    profile_steps: str = ""
    fault_injection: str = ""
    debug_nans: bool = False
    debug_checks: bool = False


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    enabled: bool = False
    ema_beta: float = 0.98
    spike_factor: float = 0.0
    ema_warmup_steps: int = 20
    max_consecutive_anomalies: int = 0
    max_rollbacks: int = 2


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    max_restarts: int = 5
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    backoff_jitter: float = 0.1
    hang_timeout_s: float = 0.0
    poll_interval_s: float = 0.5
    preempt_grace_s: float = 60.0
    heartbeat_file: str = ""
    # The reference's schema; the port keeps no compile cache, so there is
    # nothing to clear after a crash (train.compile_cache_dir is refused).
    clear_cache_on_crash: bool = True


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    enabled: bool = False
    dir: str = ""
    ring_size: int = 4096
    flight_last: int = 256
    trace_file: str = "trace.json"
    goodput_file: str = "goodput.jsonl"


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Serving engine (``serving/``; ``serve`` CLI subcommand): continuous
    batching over a paged KV cache. Every field of the reference schema is
    here; ``serving.check_serving_composition`` refuses by name the ones
    whose feature is not ported yet."""

    # Decode lanes: the decode call's fixed batch size.
    slots: int = 4
    # KV tokens per pool block.
    block_size: int = 16
    # Device-memory budget for the KV pool (all layers together); the
    # engine derives num_blocks from it.
    hbm_budget_mb: int = 128
    # Hard cap on prompt + generated tokens per request. 0 = model max_len.
    max_seq_len: int = 0
    # Prefill widths: a prompt is right-padded to the smallest that fits.
    prompt_buckets: tuple = (32, 128, 512)
    quant: str = "none"
    quant_block: int = 256
    # Stop a request when it emits this token (-1 = run to max_new_tokens).
    eos_id: int = -1
    # Emit queue-depth / free-block gauges every this many steps (0 = off).
    gauge_every: int = 0
    # Decode read path: 'reference' (gather the pages, plain attention) or
    # 'pallas' (the hand-written paged-decode kernel reads the pool in
    # place; the name is the reference schema's).
    attn_kernel: str = "reference"
    # Cap admissions (one prefill each) per engine step. 0 = uncapped.
    max_prefills_per_step: int = 0
    speculation: str = "off"
    prefix_cache: bool = False
    suffix_buckets: tuple = ()
    spill_blocks: int = 0
    spill_codec: str = "fp"
    # 'int8': pool blocks stored as int8 with one f32 scale per
    # (page slot, kv head) vector, quantized at write, dequantized on read.
    kv_quant: str = "off"
    replicas: int = 1
    router_policy: str = "least_loaded"
    shed_policy: str = "off"
    shed_percentile: float = 50.0
    heartbeat_interval_s: float = 0.05
    heartbeat_timeout_s: float = 10.0
    worker_host: str = "127.0.0.1"
    worker_port: int = 0
    max_worker_restarts: int = 3
    restart_backoff_base_s: float = 0.5
    restart_backoff_max_s: float = 15.0
    spill_checkpoint_every_s: float = 0.0
    request_retry: bool = True
    fault_injection: str = ""
    role: str = "unified"
    prefill_replicas: int = 0
    handoff_blocks_per_frame: int = 64


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    supervisor: SupervisorConfig = dataclasses.field(
        default_factory=SupervisorConfig
    )
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig
    )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def load_config(path: str) -> Config:
    """Import a config module by file path and call its ``get_config()``."""
    spec = importlib.util.spec_from_file_location("_ddl_torch_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = mod.get_config()
    if not isinstance(cfg, Config):
        raise TypeError(
            f"{path}: get_config() returned {type(cfg)}, not "
            "distributeddeeplearning_tpu_torch.config.Config"
        )
    return cfg


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``section.field=value`` overrides (values are python literals;
    bare words fall back to strings)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form a.b=value")
        dotted, raw = item.split("=", 1)
        parts = dotted.split(".")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        cfg = _replace_nested(cfg, parts, value, dotted)
    return cfg


def _coerce(value, current, dotted: str):
    """Coerce a string override to the type of the current field value, so
    e.g. ``zero1=false`` can't silently become a truthy string."""
    if not isinstance(value, str) or isinstance(current, str):
        return value
    if isinstance(current, bool):
        lowered = value.lower()
        if lowered in ("true", "1", "yes"):
            return True
        if lowered in ("false", "0", "no"):
            return False
        raise ValueError(f"{dotted}: {value!r} is not a boolean")
    if isinstance(current, (int, float)):
        raise ValueError(
            f"{dotted}: {value!r} is not a valid {type(current).__name__}"
        )
    if dataclasses.is_dataclass(current):
        names = ", ".join(f.name for f in dataclasses.fields(current))
        raise ValueError(
            f"{dotted} is a config block, not a field — set "
            f"{dotted}.<field>=... (fields: {names})"
        )
    return value


def _replace_nested(obj, parts: list[str], value, dotted: str = ""):
    field = parts[0]
    if isinstance(obj, dict):
        # Dict-valued fields (model.kwargs) accept new keys as well.
        if len(parts) == 1:
            if field in obj:
                value = _coerce(value, obj[field], dotted or field)
            return {**obj, field: value}
        if field not in obj:
            raise KeyError(f"no key {field!r} in config dict ({dotted})")
        return {
            **obj,
            field: _replace_nested(obj[field], parts[1:], value, dotted),
        }
    if not dataclasses.is_dataclass(obj) or field not in {
        f.name for f in dataclasses.fields(obj)
    }:
        raise KeyError(f"no config field {field!r} on {type(obj).__name__}")
    if len(parts) == 1:
        value = _coerce(value, getattr(obj, field), dotted or field)
        return dataclasses.replace(obj, **{field: value})
    inner = _replace_nested(getattr(obj, field), parts[1:], value, dotted)
    return dataclasses.replace(obj, **{field: inner})
