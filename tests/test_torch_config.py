"""The port's recipe reader and config tree against PyYAML and the JAX package.

- every ``recipes/*.yaml`` reads to the same dict as ``yaml.safe_load``,
  and the port's ``load_config`` gives the JAX ``load_config``'s field
  values, section by section (``dataclasses.asdict``);
- ``_parse_value`` (``--set``) equals the JAX one on a list of override
  strings, the dot-less ``1e-3`` becoming a float among them;
- the YAML 1.1 scalars, quoting and flow collections against PyYAML;
- epochs → steps, unknown keys rejected, repeated ``--set`` accumulating.
"""

import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from jumbo_mae_tpu_tpu import config as jcfg
from jumbo_mae_tpu_tpu_torch import config as tcfg
from jumbo_mae_tpu_tpu_torch.cli.train import build_parser

RECIPES = sorted((Path(__file__).resolve().parent.parent / "recipes").glob("*.yaml"))


def _same(a, b):
    """Equality that also holds NaN to NaN and tells 1 from True."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", RECIPES, ids=lambda p: p.name)
def test_recipe_reads_as_pyyaml_reads_it(path):
    text = path.read_text()
    assert _same(tcfg.yaml_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("path", RECIPES, ids=lambda p: p.name)
def test_load_config_matches_jax(path):
    got, want = tcfg.load_config(path), jcfg.load_config(path)
    for sec in ("run", "model", "optim", "data", "mesh"):
        assert dataclasses.asdict(getattr(got, sec)) == dataclasses.asdict(getattr(want, sec)), sec
    assert dataclasses.asdict(got.checkpoint_config()) == dataclasses.asdict(want.checkpoint_config())


def test_config_fields_and_defaults_match_jax():
    for ours, theirs in ((tcfg.RunConfig, jcfg.RunConfig), (tcfg.ModelConfig, jcfg.ModelConfig)):
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    from jumbo_mae_tpu_tpu.data.loader import DataConfig as JData
    from jumbo_mae_tpu_tpu.train.checkpoint import CheckpointConfig as JCkpt

    assert dataclasses.asdict(tcfg.DataConfig()) == dataclasses.asdict(JData())
    assert dataclasses.asdict(tcfg.CheckpointConfig("d")) == dataclasses.asdict(JCkpt("d"))


OVERRIDE_VALUES = ["1e-3", "1.5e-4", "-3", "true", "False", "null", "[1, 2]", "{a: 1, b: x}", "abc", '"q s"', "0.5",
                   "", "~", "1e5", "1.5e4", "0o17", "017", "0x1f", "0b101", "1_000", "yes", "off", ".inf", "-.inf",
                   ".nan", "'it''s'", '"tab\\there"', "[a, [b, c], {d: e}]", "{x: [1, 2.5], y: null, z: 'w'}",
                   "gs://bucket/x-{0000..0003}.tar", "/tmp/a b", "1:30", "a: 1", "{a: }", "[]", "{}", "3.",
                   "+12", "- x"]


@pytest.mark.parametrize("text", OVERRIDE_VALUES)
def test_parse_value_matches_jax(text):
    try:
        want = jcfg._parse_value(text)
    except yaml.YAMLError:
        # outside the subset for PyYAML too: the port raises as well
        with pytest.raises(ValueError):
            tcfg._parse_value(text)
        return
    if text == "- x":  # a block sequence: outside the subset, refused
        with pytest.raises(ValueError, match="block sequences"):
            tcfg._parse_value(text)
        return
    assert _same(tcfg._parse_value(text), want), text


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n  c:\n    d: x  # comment\n  e: 'q # not a comment'\n",
    "# head\nk: {a: 1,\n    b: [1,\n        2]}\nz: end\n",
    "key: \"esc \\\" \\u00e9\"\nother: plain text with:colon inside\n",
    "empty:\nnext: 1\n",
    "'quoted key': 1\n\"dq\": 2\n",
    "x: 2001-01-01x\ny: 1.0e+3\nz: 1.0E-3\nw: 6.\n",
])
def test_documents_match_pyyaml(text):
    assert _same(tcfg.yaml_load(text), yaml.safe_load(text))


def test_subset_refuses_what_it_does_not_read():
    for text in ("a: &x 1\nb: *x\n", "a: |\n  text\n", "a: !!str 1\n", "- 1\n- 2\n", "a:\n  - 1\n"):
        with pytest.raises(ValueError):
            tcfg.yaml_load(text)


def test_epochs_to_steps_and_dataset_size():
    doc = {"run": {"train_batch_size": 128, "epochs": 0.75}, "optim": {"warmup_epochs": 0}, "data": {"dataset_size": 1024}}
    got, want = tcfg.config_from_dict(doc), jcfg.config_from_dict(doc)
    assert got.run.training_steps == want.run.training_steps == 6
    assert got.optim.warmup_steps == 0 and got.optim.training_steps == 6
    cfg = tcfg.config_from_dict({"run": {"train_batch_size": 4096, "epochs": 800}})
    assert cfg.run.training_steps == tcfg.steps_from_epochs(800, 4096) == 1_281_167 * 800 // 4096
    for bad in (0, -5, 1.5, "lots", True):
        with pytest.raises(ValueError, match="dataset_size"):
            tcfg.config_from_dict({"data": {"dataset_size": bad}})


def test_unknown_keys_rejected():
    with pytest.raises(ValueError, match="unknown RunConfig keys"):
        tcfg.config_from_dict({"run": {"no_such_field": 1}})
    with pytest.raises(ValueError, match="unknown config sections"):
        tcfg.config_from_dict({"nope": {}})
    with pytest.raises(ValueError, match="key.path=value"):
        tcfg.apply_overrides({}, ["novalue"])
    with pytest.raises(ValueError, match="through scalar"):
        tcfg.apply_overrides({"run": 3}, ["run.x=1"])


def test_repeated_set_accumulates():
    args = build_parser().parse_args(["--set", "run.seed=3", "--set", "optim.learning_rate=1e-3", "data.workers=0"])
    assert args.overrides == ["run.seed=3", "optim.learning_rate=1e-3", "data.workers=0"]
    cfg = tcfg.load_config(RECIPES[0].parent / "smoke_cpu.yaml", args.overrides)
    assert (cfg.run.seed, cfg.optim.learning_rate, cfg.data.workers) == (3, 1e-3, 0)
    assert cfg == jcfg_to_port(jcfg.load_config(RECIPES[0].parent / "smoke_cpu.yaml", args.overrides))


def jcfg_to_port(cfg):
    """The JAX TrainConfig rebuilt as the port's, through the dict form."""
    return tcfg.config_from_dict({k: v for k, v in jcfg.config_to_dict(cfg).items()})
