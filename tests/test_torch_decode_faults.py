"""The data side of the run's faults, against the JAX package, on the CPU.

Both train streams of the port (``train_sample_stream``, and
``native_train_stream`` at one decode thread, so a counting selector picks
the same decodes) cross the ``data.decode`` fault site before each decode
and feed ``data_decode_seconds`` and ``data_decode_failures_total``:

(a) over a shard with two members whose image bytes cannot be decoded, the
    port's stream equals the JAX stream sample for sample, bit for bit;
    both failure counters read 2 and both decode counts are equal;
(b) under ``data.decode:corrupt(N)@key~K``, N large enough that K cannot
    decode (``@n=`` at K's place in the decode order in the native stream,
    whose reader hands out no key), the stream equals the unfaulted stream
    (the port's and the JAX one's) over shards in which K's payload was
    replaced by the port's own ``corrupt`` of it (the JAX ``corrupt`` seeds ``random.Random`` with a
    tuple, which Python 3.12 refuses: ROADMAP C.R1);
(c) under ``data.decode:raise@n=M`` both packages raise the same exception
    type after yielding the same samples.
(d) Both train CLIs on ``recipes/smoke_cpu.yaml`` over shards of which one
    is truncated, with a save every 2 steps, journal equal ``quarantine``
    and ``shard_cursor`` rows (``ts``, ``seq`` and ``host`` dropped), in
    the same places among the ``step`` rows.
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.data import loader as jloader
from jumbo_mae_tpu_tpu.data import tario as jtario
from jumbo_mae_tpu_tpu.faults import inject as jinject
from jumbo_mae_tpu_tpu.obs import metrics as jmetrics
from jumbo_mae_tpu_tpu_torch.data import loader as tloader
from jumbo_mae_tpu_tpu_torch.data import tario as ttario
from jumbo_mae_tpu_tpu_torch.faults import inject as tinject
from jumbo_mae_tpu_tpu_torch.obs import metrics as tmetrics

SMOKE = Path(__file__).resolve().parent.parent / "recipes" / "smoke_cpu.yaml"
BAD = ("t00002", "t00009")  # members whose bytes are no image
PER_EPOCH = 12 - len(BAD)
STREAMS = ("python", "native")


@pytest.fixture(autouse=True)
def no_plan_left():
    yield
    jinject.clear_plan()
    tinject.clear_plan()


def _png(rng) -> bytes:
    from PIL import Image

    h, w = (int(x) for x in rng.integers(20, 40, 2))
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB").save(buf, format="PNG")
    return buf.getvalue()


def _members(seed: int = 0) -> list[list[dict]]:
    """2 shards × 6 PNG members; the ``BAD`` keys carry bytes no decoder takes."""
    rng = np.random.default_rng(seed)
    shards = []
    for s in range(2):
        samples = []
        for i in range(6):
            key = f"t{6 * s + i:05d}"
            payload = b"no image here" * 4 if key in BAD else _png(rng)
            samples.append({"__key__": key, "png": payload, "cls": str((6 * s + i) % 10).encode()})
        shards.append(samples)
    return shards


def _write(root: Path, shards: list[list[dict]]) -> str:
    root.mkdir(parents=True, exist_ok=True)
    for s, samples in enumerate(shards):
        ttario.write_tar_samples(str(root / f"train-{s:04d}.tar"), samples)
    return f"{root}/train-{{0000..0001}}.tar"


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("decode_shards"), _members())


def _cfgs(urls: str, stream: str):
    doc = dict(train_shards=urls, image_size=16, shuffle_buffer=5, seed=3, use_native=stream == "native",
               decode_threads=1)
    return tloader.DataConfig(**doc), jloader.DataConfig(**doc)


def _stream(pkg, cfg, stream: str):
    return (pkg.native_train_stream if stream == "native" else pkg.train_sample_stream)(cfg)


def _take(it, n: int) -> list:
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _take_until_raise(it, n: int):
    out = []
    try:
        for _ in range(n):
            out.append(next(it))
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return out, type(e)
    return out, None


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, ((gi, gl), (wi, wl)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi, err_msg=f"sample {i}")
        assert gl == wl, i


def _decode_counts(reg) -> tuple[float, float]:
    snap = reg.snapshot()
    seconds = snap.get("data_decode_seconds", {}).get("", {"count": 0})
    return seconds["count"], snap.get("data_decode_failures_total", {}).get("", 0.0)


@pytest.mark.parametrize("stream", STREAMS)
def test_undecodable_members_are_dropped_and_counted_as_jax(shards, stream):
    tcfg, jcfg = _cfgs(shards, stream)
    regs = (tmetrics.get_registry(), jmetrics.get_registry())
    before = [_decode_counts(r) for r in regs]
    got = _take(_stream(tloader, tcfg, stream), PER_EPOCH)  # one epoch: every member decoded once
    t_after = _decode_counts(regs[0])
    want = _take(_stream(jloader, jcfg, stream), PER_EPOCH)
    j_after = _decode_counts(regs[1])
    _assert_same(got, want)
    deltas = [tuple(a - b for a, b in zip(after, bef)) for after, bef in zip((t_after, j_after), before)]
    assert deltas[0] == deltas[1] == (12, 2)


@pytest.mark.parametrize("stream", STREAMS)
def test_a_corrupted_decode_equals_the_stream_over_its_corrupted_payload(shards, stream, tmp_path, monkeypatch):
    key, corrupt = "t00004", "data.decode:corrupt(4096)"
    members = _members()
    payload = members[0][4]["png"]
    # the oracle: the port's own corrupt of K's payload, at a rule's first firing
    tinject.install_plan(corrupt)
    members[0][4]["png"] = tinject.fault_point("data.decode", key=key, data=payload)
    tinject.clear_plan()
    assert members[0][4]["png"] != payload
    replaced = _write(tmp_path / "replaced", members)
    tcfg_r, jcfg_r = _cfgs(replaced, stream)
    want_port = _take(_stream(tloader, tcfg_r, stream), PER_EPOCH - 1)
    want_jax = _take(_stream(jloader, jcfg_r, stream), PER_EPOCH - 1)
    _assert_same(want_port, want_jax)
    tcfg = _cfgs(shards, stream)[0]
    if stream == "python":
        plan = f"{corrupt}@key~{key}"
    else:  # the native reader hands out no key: select K by its place in the decode order
        seen, real = [], tloader.decode_image
        monkeypatch.setattr(tloader, "decode_image", lambda p: (seen.append(bytes(p)), real(p))[1])
        _take(_stream(tloader, tcfg, stream), PER_EPOCH)
        monkeypatch.setattr(tloader, "decode_image", real)
        plan = f"{corrupt}@n={seen.index(payload)}"
    tinject.install_plan(plan)
    before = _decode_counts(tmetrics.get_registry())
    got = _take(_stream(tloader, tcfg, stream), PER_EPOCH - 1)
    after = _decode_counts(tmetrics.get_registry())
    _assert_same(got, want_port)
    assert after[1] - before[1] == 3  # the two bad members and the corrupted one


@pytest.mark.parametrize("stream", STREAMS)
def test_a_raise_at_a_decode_raises_the_jax_type_after_the_same_samples(shards, stream):
    tcfg, jcfg = _cfgs(shards, stream)
    tinject.install_plan("data.decode:raise@n=8")
    jinject.install_plan("data.decode:raise@n=8")
    got, got_exc = _take_until_raise(_stream(tloader, tcfg, stream), 3 * PER_EPOCH)
    want, want_exc = _take_until_raise(_stream(jloader, jcfg, stream), 3 * PER_EPOCH)
    assert got_exc is want_exc is OSError
    assert len(got) > 0
    _assert_same(got, want)


# ------------------------------------------------ (d) the journal rows of both CLIs


def _rows(events) -> list:
    keep = ("step", "quarantine", "shard_cursor")
    out = []
    for e in events:
        if e["type"] == "step":
            out.append(("step", e["step"]))
        elif e["type"] in keep:
            out.append({k: v for k, v in e.items() if k not in ("ts", "seq", "host")})
    return out


def test_quarantine_and_shard_cursor_rows_equal_the_jax_cli(tmp_path):
    from PIL import Image

    from jumbo_mae_tpu_tpu.cli.train import train as jtrain
    from jumbo_mae_tpu_tpu.config import load_config as jload_config
    from jumbo_mae_tpu_tpu.obs.journal import read_journal as jread_journal
    from jumbo_mae_tpu_tpu_torch.cli import train as ttrain
    from jumbo_mae_tpu_tpu_torch.config import load_config
    from jumbo_mae_tpu_tpu_torch.obs.journal import read_journal

    rng = np.random.default_rng(1)
    root = tmp_path / "shards"
    root.mkdir()
    for s in range(3):
        samples = []
        for i in range(8):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8), "RGB").save(buf, format="PNG")
            samples.append({"__key__": f"c{8 * s + i:05d}", "png": buf.getvalue(), "cls": str(i).encode()})
        ttario.write_tar_samples(str(root / f"train-{s:04d}.tar"), samples)
    bad = root / "train-0001.tar"
    bad.write_bytes(bad.read_bytes()[: len(bad.read_bytes()) // 2])  # a truncated shard
    overrides = lambda out: [  # noqa: E731
        f"run.output_dir={out}", "run.synthetic_data=false", f"data.train_shards={root}/train-{{0000..0002}}.tar",
        "data.valid_shards=", "data.dataset_size=24", "data.shuffle_buffer=8", "data.shard_retry_backoff_s=0",
        "run.train_batch_size=8", "run.training_steps=6", "optim.training_steps=10", "run.log_interval=1",
        "run.ckpt_every=2", "run.eval_interval=0", "run.sanity_eval=false"]
    rows = []
    for quarantine, run, read in ((jtario.QUARANTINE, lambda o: jtrain(jload_config(SMOKE, overrides(o))),
                                   jread_journal),
                                  (ttario.QUARANTINE, lambda o: ttrain.train(load_config(SMOKE, overrides(o)),
                                                                             device="cpu"), read_journal)):
        quarantine.clear()
        try:
            out = tmp_path / str(len(rows))
            run(out)
            rows.append(_rows(read(out / "smoke_cpu")))
        finally:
            quarantine.clear()
    want, got = rows
    assert got == want
    assert [r["shards"] for r in got if isinstance(r, dict) and r["type"] == "quarantine"] == [[str(bad)]]
    cursors = [r for r in got if isinstance(r, dict) and r["type"] == "shard_cursor"]
    assert [r["step"] for r in cursors] == [2, 4, 6] and {r["world"] for r in cursors} == {1}
    # the save keeps its copy of the ledger
    extra = json.loads((tmp_path / "1" / "smoke_cpu" / "ckpt" / "last" / "6" / "extra.json").read_text())
    assert extra["shard_cursor"] == {k: v for k, v in cursors[-1].items() if k not in ("type", "step", "world")}
