"""Run configuration: a dataclass tree read from YAML recipes plus overrides.

Counterpart of ``jumbo_mae_tpu_tpu/config.py``: the same sections, fields,
defaults and arithmetic (``epochs:`` keys converted to steps against the
global batch and ``data.dataset_size``), so every recipe of ``recipes/``
gives the same field values in both packages.

Recipes are read by :func:`yaml_load`, a reader of the YAML subset the
recipes use, written here so the port needs no PyYAML: comments, nested
block mappings, flow mappings and flow lists (which may span lines),
single- and double-quoted strings, plain strings and the YAML 1.1 scalars
PyYAML's ``safe_load`` resolves (ints in every base, floats such as
``1.5e-4``, ``.inf``/``.nan``, the booleans ``true/yes/on``... and
``null``/``~``/empty). Anchors, tags, block sequences and multi-line
plain or block scalars raise ``ValueError``. The same reader runs on
every machine, whether PyYAML is installed there or not.

Override grammar: ``--set optim.learning_rate=1e-3 data.workers=0`` —
dotted paths into the tree, each value read as a YAML document, and a
dot-less ``1e-3`` (a string to YAML 1.1) taken as a float.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Literal

from jumbo_mae_tpu_tpu_torch.data.loader import DataConfig
from jumbo_mae_tpu_tpu_torch.parallel.mesh import MeshConfig
from jumbo_mae_tpu_tpu_torch.train.checkpoint import CheckpointConfig
from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig

IMAGENET_TRAIN_SIZE = 1_281_167

Mode = Literal["pretrain", "finetune", "linear"]


@dataclass(frozen=True)
class ModelConfig:
    """Encoder/decoder selection: a preset name plus field overrides (the
    JAX package's fields and defaults)."""

    preset: str = "vit_b16"
    overrides: dict[str, Any] = field(default_factory=dict)
    dec_layers: int = 8
    dec_dim: int = 512
    dec_heads: int = 16
    dec_dtype: str = "bfloat16"
    dec_overrides: dict[str, Any] = field(default_factory=dict)
    norm_pix_loss: bool = True
    # classifier head (finetune/linear only)
    mixup: float = 0.0
    cutmix: float = 0.0
    label_smoothing: float = 0.0
    criterion: str = "ce"


@dataclass(frozen=True)
class RunConfig:
    """Every field of the JAX package's ``RunConfig``, with its default, so
    every recipe round-trips. ``cli/train.py`` says which of them the port
    runs and which raise, naming the ROADMAP item that brings them."""

    mode: Mode = "pretrain"
    name: str = "run"
    output_dir: str = "runs"
    seed: int = 0
    init_seed: int = 0

    training_steps: int = 100
    log_interval: int = 50
    eval_interval: int = 1000
    ckpt_every: int = 0

    train_batch_size: int = 256  # GLOBAL batch
    valid_batch_size: int = 256
    grad_accum: int = 1

    synthetic_data: bool = False
    sanity_eval: bool = True
    eval_only: bool = False
    eval_which: str = "last"
    resume: bool = False
    pretrained_ckpt: str = ""
    profile_dir: str = ""
    # resilience (faults/ in the JAX package)
    sentinel: bool = True
    sentinel_patience: int = 3
    sentinel_spike_factor: float = 10.0
    sentinel_ema_beta: float = 0.98
    sentinel_max_rollbacks: int = 3
    faults: str = ""
    # diagnostics
    diag_every: int = 0
    journal: bool = True
    flightrec_steps: int = 256
    retrace: bool = True
    # telemetry
    telemetry: bool = False
    telemetry_port: int = 9100
    telemetry_host: str = "0.0.0.0"
    # fleet health
    fleet: bool = True
    fleet_lag_steps: int = 2
    fleet_ratio: float = 1.5
    fleet_dead_after_s: float = 60.0
    # elastic training
    hangwatch_deadline_s: float = 0.0
    elastic_max_restarts: int = 8
    elastic_backoff_s: float = 1.0
    elastic_backoff_cap_s: float = 60.0
    elastic_wedge_after_s: float = 0.0
    elastic_rejoin_after_s: float = 30.0
    # memory observability
    memwatch: bool = True
    memwatch_leak_window: int = 12
    memwatch_leak_mb: float = 32.0
    # serving SLOs
    slo: str = ""
    slo_window_s: float = 60.0
    slo_fast_window_s: float = 0.0
    slo_burn_threshold: float = 1.0
    # continuous deployment
    publish_dir: str = ""
    publish_quant: str = "int8"
    publish_min_interval_steps: int = 0
    publish_full_every: int = 8
    publish_metric_key: str = ""
    publish_metric_floor: float = 0.0
    publish_metric_sense: str = "below"
    chrome_trace: str = ""
    use_wandb: bool = True
    wandb_project: str = ""
    wandb_entity: str = ""
    wandb_tags: tuple = ()
    wandb_id: str = ""


@dataclass(frozen=True)
class TrainConfig:
    run: RunConfig = field(default_factory=RunConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def checkpoint_config(self) -> CheckpointConfig:
        best_by_loss = self.run.mode == "pretrain"
        return CheckpointConfig(
            directory=str(Path(self.run.output_dir) / self.run.name / "ckpt"),
            best_mode="min" if best_by_loss else "max",
            metric_key="val/loss" if best_by_loss else "val/acc1",
        )


def steps_from_epochs(epochs: float, global_batch: int, dataset_size: int = IMAGENET_TRAIN_SIZE) -> int:
    return int(dataset_size * epochs / global_batch)


_SECTIONS = {
    "run": RunConfig,
    "model": ModelConfig,
    "optim": OptimConfig,
    "data": DataConfig,
    "mesh": MeshConfig,
}


def _coerce(cls, raw: dict) -> Any:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**raw)


def _resolve_epochs(doc: dict) -> dict:
    """``epochs`` / ``warmup_epochs`` in the run/optim sections become steps
    against the global train batch and the one dataset size
    (``data.dataset_size``, else a top-level ``dataset_size``, else
    ImageNet's), which also feeds the coarse resume cursor."""
    doc = {k: dict(v) if isinstance(v, dict) else v for k, v in doc.items()}
    run = doc.get("run", {})
    batch = run.get("train_batch_size", RunConfig.train_batch_size)
    top_level = doc.pop("dataset_size", None)
    data_sec = doc.setdefault("data", {})
    dataset = data_sec.get("dataset_size", top_level)
    if dataset is None:
        dataset = IMAGENET_TRAIN_SIZE
    elif not isinstance(dataset, int) or isinstance(dataset, bool) or dataset <= 0:
        raise ValueError(f"dataset_size must be a positive int, got {dataset!r}")
    data_sec["dataset_size"] = dataset
    if "epochs" in run:
        run["training_steps"] = steps_from_epochs(run.pop("epochs"), batch, dataset)
    optim = doc.get("optim", {})
    if "warmup_epochs" in optim:
        optim["warmup_steps"] = steps_from_epochs(optim.pop("warmup_epochs"), batch, dataset)
    optim.setdefault("training_steps", run.get("training_steps", RunConfig.training_steps))
    doc["run"], doc["optim"] = run, optim
    return doc


def config_from_dict(doc: dict) -> TrainConfig:
    doc = _resolve_epochs(doc or {})
    unknown = set(doc) - set(_SECTIONS)
    if unknown:
        raise ValueError(f"unknown config sections: {sorted(unknown)}")
    return TrainConfig(**{sec: _coerce(cls, doc.get(sec, {})) for sec, cls in _SECTIONS.items()})


# ------------------------------------------------------------ the YAML subset

# PyYAML's YAML 1.1 implicit resolvers for plain scalars
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOW_INDICATORS = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    digits = [cast(part) for part in text.lstrip("+-").split(":")]
    value, base = 0, 1
    for d in reversed(digits):
        value += d * base
        base *= 60
    return sign * value


def _resolve_plain(text: str) -> Any:
    """A plain scalar as PyYAML's ``safe_load`` types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return text


class _Reader:
    """A cursor over one flow node or one line's scalar."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def error(self, what: str) -> ValueError:
        return ValueError(f"YAML subset: {what} at column {self.i} of {self.s!r}")

    def skip_space(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n\r":
            self.i += 1
        if self.i < len(self.s) and self.s[self.i] == "#":  # comment to end of line
            while self.i < len(self.s) and self.s[self.i] != "\n":
                self.i += 1
            self.skip_space()

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated quoted string")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1 : self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.i + 1 : self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[e]
                    out.append(chr(int(self.s[self.i + 2 : self.i + 2 + n], 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            if c == "\n":  # a quoted string folded over lines: one space
                while out and out[-1] in " \t":
                    out.pop()
                self.i += 1
                while self.i < len(self.s) and self.s[self.i] in " \t":
                    self.i += 1
                out.append(" ")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar: in a flow collection it ends at a flow indicator
        or at ``: ``; it always ends at `` #``."""
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1 : self.i + 2]
            if c == "\n" or (c == "#" and self.i > start and self.s[self.i - 1] in " \t"):
                break
            if flow and (c in _FLOW_INDICATORS or (c == ":" and (nxt == "" or nxt in " \t\n" + _FLOW_INDICATORS))):
                break
            self.i += 1
        return self.s[start : self.i].strip()

    def node(self, flow: bool) -> Any:
        self.skip_space()
        c = self.peek()
        if c == "{":
            return self.mapping()
        if c == "[":
            return self.sequence()
        if c in ("'", '"'):
            return self.quoted()
        if c in ("&", "*", "!", "|", ">", "%", "@", "`"):
            raise self.error(f"unsupported YAML ({c!r})")
        return _resolve_plain(self.plain(flow))

    def mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip_space()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.node(flow=True)
            self.skip_space()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_space()
                value = None if self.peek() in (",", "}") else self.node(flow=True)
                self.skip_space()
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}'")

    def sequence(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self.skip_space()
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.node(flow=True))
            self.skip_space()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']'")

    def end(self) -> None:
        self.skip_space()
        if self.i != len(self.s):
            raise self.error("trailing characters")


def _value(text: str) -> Any:
    """One node's text (a scalar, or a flow collection over one or more
    lines) as PyYAML's ``safe_load`` reads it."""
    r = _Reader(text)
    v = r.node(flow=False)
    r.end()
    return v


def _key_split(line: str) -> tuple[str, str] | None:
    """``key: rest`` → (key, rest); None when the line is not a mapping
    entry (``:`` must be followed by a blank or end the line)."""
    if line[:1] in ("'", '"'):
        r = _Reader(line)
        key = r.quoted()
        rest = line[r.i :].lstrip(" \t")
        return (key, rest[1:].strip()) if rest.startswith(":") else None
    if line[:1] in ("{", "[", "#"):
        return None
    for m in re.finditer(r":(?=[ \t]|$)", line):
        head = line[: m.start()]
        if " #" in head or "\t#" in head:
            return None
        return head.rstrip(), line[m.end() :].strip()
    return None


def _flow_balance(text: str) -> int:
    """Open minus closed flow brackets outside quotes and comments."""
    depth, quote = 0, ""
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = ""
            continue
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            break
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def yaml_load(text: str) -> Any:
    """Read a YAML document of the subset the recipes use (module
    docstring) into dicts, lists and scalars, as ``yaml.safe_load`` would."""
    lines = []
    for raw in text.splitlines():
        stripped = raw.strip()
        if stripped in ("---", "...") or not stripped or stripped.startswith("#"):
            continue
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"YAML subset: tab indentation in {raw!r}")
        lines.append((len(raw) - len(raw.lstrip(" ")), raw.strip()))
    if not lines:
        return None
    pos = 0

    def take_value(first: str) -> str:
        """``first`` plus the continuation lines of an open flow node."""
        nonlocal pos
        parts = [first]
        while _flow_balance("\n".join(parts)) > 0 and pos < len(lines):
            parts.append(lines[pos][1])
            pos += 1
        return "\n".join(parts)

    def block(indent: int) -> Any:
        nonlocal pos
        first_indent, first = lines[pos]
        if first.startswith("- ") or first == "-":
            raise ValueError(f"YAML subset: block sequences are not supported ({first!r})")
        if _key_split(first) is None:
            pos += 1
            value = _value(take_value(first))
            if pos < len(lines) and lines[pos][0] >= indent:
                raise ValueError(f"YAML subset: unexpected line {lines[pos][1]!r}")
            return value
        out: dict = {}
        while pos < len(lines) and lines[pos][0] == first_indent:
            split = _key_split(lines[pos][1])
            if split is None:
                raise ValueError(f"YAML subset: expected 'key: value', got {lines[pos][1]!r}")
            key, rest = split
            key = _value(key) if key[:1] in ("'", '"') else _resolve_plain(key)
            pos += 1
            if rest and not rest.startswith("#"):
                out[key] = _value(take_value(rest))
            elif pos < len(lines) and lines[pos][0] > first_indent:
                out[key] = block(lines[pos][0])
            else:
                out[key] = None
        if pos < len(lines) and lines[pos][0] > first_indent:
            raise ValueError(f"YAML subset: bad indentation at {lines[pos][1]!r}")
        return out

    doc = block(lines[0][0])
    if pos != len(lines):
        raise ValueError(f"YAML subset: bad indentation at {lines[pos][1]!r}")
    return doc


# ------------------------------------------------------------ overrides

def _parse_value(text: str) -> Any:
    value = yaml_load(text)
    if isinstance(value, str):
        # YAML 1.1 doesn't recognize dot-less scientific notation ("1e-3")
        try:
            return float(value)
        except ValueError:
            return value
    return value


def apply_overrides(doc: dict, overrides: list[str]) -> dict:
    doc = {k: dict(v) if isinstance(v, dict) else v for k, v in doc.items()}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key.path=value, got {item!r}")
        path, value = item.split("=", 1)
        keys = path.split(".")
        node = doc
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(f"cannot override through scalar at {k!r}")
        node[keys[-1]] = _parse_value(value)
    return doc


def load_config(path: str | Path | None = None, overrides: list[str] | None = None) -> TrainConfig:
    doc: dict = {}
    if path is not None:
        doc = yaml_load(Path(path).read_text()) or {}
    doc = apply_overrides(doc, overrides or [])
    return config_from_dict(doc)


def config_to_dict(cfg: TrainConfig) -> dict:
    return dataclasses.asdict(cfg)
