"""Config trees: TOML loading and writing, attribute access, the summaries
a logger records and the schema checks of the keys the port reads (the
subset of ``medtsllm_tpu/config.py``: ``Config``, ``load_config``,
``loads_config``, ``dumps_toml``, ``save_config``, ``summarize_config``,
``flatten_dict``, ``get_logging_tags`` and ``validate_config``).

Any mapping with attribute access and ``.get`` works as a config, the JAX
package's ``Config`` included; this one lets the port run without that
package.
"""

from __future__ import annotations

import copy as _copy
import datetime
import io
import tomllib
from typing import Any


class Config:
    """Recursive attribute-access wrapper over a nested dict: attribute and
    item access, ``in``, ``.get(key, default)``, ``items``, ``copy``,
    ``merge`` and ``to_dict``."""

    __slots__ = ("_data",)

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {k: _wrap(v) for k, v in (data or {}).items()})

    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(f"Config has no key {key!r}") from None

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, _wrap(default))

    def items(self):
        return self._data.items()

    def copy(self) -> "Config":
        return Config(_copy.deepcopy(self.to_dict()))

    def merge(self, other: "Config | dict") -> "Config":
        """Deep-merge ``other`` on top of self, returning a new Config."""
        return Config(_deep_merge(self.to_dict(), dict(_plain(other))))

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self._data.items()}


def _wrap(v: Any) -> Any:
    return Config(v) if isinstance(v, dict) else v


def _plain(d) -> dict:
    """A config (this package's, the JAX package's or any mapping with
    ``to_dict``) or a dict -> a nested dict."""
    return d.to_dict() if hasattr(d, "to_dict") else d


def _deep_merge(base: dict, upd: dict) -> dict:
    out = dict(base)
    for k, v in upd.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path) -> Config:
    with open(path, "rb") as f:
        return Config(tomllib.load(f))


def loads_config(text: str) -> Config:
    return Config(tomllib.loads(text))


# ---------------------------------------------------------------------------
# TOML writing (the standard library has none): a run directory's
# config.toml, byte for byte what medtsllm_tpu/config.py:141-182 writes
# ---------------------------------------------------------------------------

def _fmt_toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, datetime.datetime):
        return v.isoformat()
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_toml_value(x) for x in v) + "]"
    raise TypeError(f"Cannot serialize {type(v)} to TOML")


def dumps_toml(d: dict | Config, _prefix: str = "") -> str:
    d = _plain(d)
    buf = io.StringIO()
    tables = {}
    for k, v in d.items():
        if isinstance(v, dict):
            tables[k] = v
        else:
            buf.write(f"{k} = {_fmt_toml_value(v)}\n")
    for k, v in tables.items():
        name = f"{_prefix}{k}"
        body = dumps_toml(v, _prefix=f"{name}.")
        # a table header only over scalars (or an empty table)
        if any(not isinstance(x, dict) for x in v.values()) or not v:
            buf.write(f"\n[{name}]\n")
        buf.write(body)
    return buf.getvalue()


def save_config(config: dict | Config, path) -> None:
    with open(path, "w") as f:
        f.write(dumps_toml(config))


# ---------------------------------------------------------------------------
# what the loggers record (medtsllm_tpu/config.py:185-231)
# ---------------------------------------------------------------------------

def summarize_config(config) -> Config:
    """The config with its ``models``, ``tasks`` and ``datasets`` tables
    pruned to the active model (``timellm`` and ``medtsllm`` are one),
    task and dataset."""
    cfg = _copy.deepcopy(_plain(config))
    model = cfg.get("model")
    models = {model} | ({"timellm", "medtsllm"} if model in ("timellm", "medtsllm") else set())
    for section, active in (("models", models), ("tasks", {cfg.get("task")}),
                            ("datasets", {cfg.get("data", {}).get("dataset")})):
        if section in cfg:
            cfg[section] = {k: v for k, v in cfg[section].items() if k in active}
    return Config(cfg)


def flatten_dict(d: dict | Config, prefix: str = "", sep: str = "/") -> dict:
    d = _plain(d)
    out = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


def get_logging_tags(config) -> list[str]:
    tags = [config.get("task", ""), config.get("model", "")]
    if "data" in config:
        tags.append(config.data.get("dataset", ""))
    if "study" in config:
        tags.append(str(config.study))
    return [t for t in tags if t]


# the names validate_config knows (medtsllm_tpu/config.py:239-254)
KNOWN_TASKS = ("forecasting", "reconstruction", "anomaly_detection", "segmentation",
               "semantic_segmentation", "pretraining", "classification", "imputation")
KNOWN_MODELS = ("medtsllm", "timellm", "gpt4ts", "dlinear", "patchtst", "timesnet",
                "fedformer")
KNOWN_OPTIMIZERS = ("adam", "adamw", "sgd", "ranger", "ranger21", "ranger_classic")
KNOWN_SCHEDULERS = ("none", "constant", "cosine", "linear")
KNOWN_DTYPES = ("bfloat16", "bf16", "float16", "half", "fp16", "16", "float32", "float",
                "fp32", "32", "mixed")


class ConfigError(ValueError):
    pass


def validate_config(config):
    """The checks of ``medtsllm_tpu/config.py:256-341`` on the keys the
    port reads: task, model, lengths, dataset, optimizer, scheduler,
    ``setup.dtype``, the aligned-window tasks' equal lengths, the
    anomaly-detection and segmentation tables and finetuning's exclusive
    ``frozen_epochs`` / ``warmup_epochs``; and the prompting keys of the
    per-clip head, ``clip_head`` and ``clip_cache_slots``."""
    def require(cond, msg):
        if not cond:
            raise ConfigError(msg)

    require("task" in config, "config missing top-level `task`")
    require("model" in config, "config missing top-level `model`")
    require(config.task in KNOWN_TASKS, f"unknown task {config.task!r}")
    require(config.model in KNOWN_MODELS, f"unknown model {config.model!r}")
    require("history_len" in config and "pred_len" in config,
            "config missing history_len/pred_len")
    require("data" in config and "dataset" in config.data, "config missing [data] dataset")
    require("training" in config, "config missing [training]")
    t = config.training
    require(t.get("optimizer", "adam") in KNOWN_OPTIMIZERS,
            f"invalid optimizer {t.get('optimizer')!r}")
    require(t.get("lr_scheduler") in (None,) + KNOWN_SCHEDULERS,
            f"invalid lr_scheduler {t.get('lr_scheduler')!r}")
    require(int(t.get("grad_accum_steps", 1) or 1) >= 1,
            "training.grad_accum_steps must be >= 1")
    require(float(t.get("grad_clip_norm", 0) or 0) >= 0,
            "training.grad_clip_norm must be >= 0")
    if "setup" in config:
        dt = config.setup.get("dtype", "float32")
        require(dt in KNOWN_DTYPES or isinstance(dt, int), f"invalid dtype {dt!r}")
    if config.task in ("reconstruction", "anomaly_detection", "semantic_segmentation",
                       "segmentation", "classification", "imputation"):
        require(config.history_len == config.pred_len,
                f"{config.task} requires history_len == pred_len "
                f"(got {config.history_len} != {config.pred_len})")
    tasks = config.get("tasks", {})
    if config.task == "anomaly_detection":
        ad = tasks.get("anomaly_detection", None)
        require(ad is not None and "threshold" in ad and "normalize_by_feature" in ad,
                "anomaly_detection requires [tasks.anomaly_detection] with `threshold` "
                "and `normalize_by_feature`")
    if config.task == "segmentation":
        sg = tasks.get("segmentation", None)
        require(sg is not None and "mode" in sg and "distance_thresh" in sg,
                "segmentation requires [tasks.segmentation] with `mode` and "
                "`distance_thresh`")
    if "finetuning" in config and config.finetuning.get("enabled", False):
        f = config.finetuning
        require(not (f.get("frozen_epochs", 0) > 0 and f.get("warmup_epochs", 0) > 0),
                "finetuning frozen_epochs and warmup_epochs are mutually exclusive")
    # the per-clip head's switch and its KV bank's rows (PromptBuilder)
    models = config.models.to_dict() if "models" in config else {}
    for mc in models.values():
        prompting = (mc.get("prompting") if isinstance(mc, dict) else None) or {}
        require(isinstance(prompting.get("clip_head", True), bool),
                "prompting.clip_head must be true or false")
        slots = prompting.get("clip_cache_slots", 8)
        require(type(slots) is int and slots >= 1,
                f"prompting.clip_cache_slots must be a positive integer, not {slots!r}")
    return config
