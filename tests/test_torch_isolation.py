"""The port's boundary rules.

- ``jumbo_mae_tpu_tpu_torch/`` and ``chip_smoke.py`` never import JAX, its
  libraries or the JAX package (an AST scan of every import statement);
- every module of the port imports in a fresh interpreter where importing
  any of those raises, and so does importing PyYAML, PIL or cv2 (the port
  must run without them); ``cli.train.main`` trains ``smoke_cpu.yaml`` on
  the CPU in such an interpreter;
- an augmentation policy without PIL raises ``ImportError`` naming it, at
  the policy and at the loader, while the rest of the port runs;
- the entry points (the engine, ``cli.predict``, ``cli.train``,
  ``cli.batch``, the warm-cache probe, the tools and the performance
  model) default to the GPU and raise when there is none, instead of
  carrying on on the CPU; a save is served and its features exported, a
  batch job runs and is audited, a warm restart loads its cache, and a
  budgeted job, a publishing run and tenant-metered serving are billed
  and audited, and a pool serves behind the ``/metrics`` exporter, the
  SLO tracker, the memory watcher and the capture sentinel, scraped over
  loopback and read by the serve doctor, in the blocked interpreter;
- no kernel is built at import time.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu_torch.cli import predict
from jumbo_mae_tpu_tpu_torch.config import load_config
from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine
from jumbo_mae_tpu_tpu_torch.models import JumboViT, preset
from jumbo_mae_tpu_tpu_torch.tools import extract_features, knn_probe
from jumbo_mae_tpu_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "jumbo_mae_tpu_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "jumbo_mae_tpu_tpu", "yaml")
# blocked beside FORBIDDEN in the fresh interpreter: the port imports PIL
# and cv2 only lazily or under try, never msgpack (its flax msgpack codec
# is its own), and must run without any of these
OPTIONAL = ("yaml", "PIL", "cv2", "msgpack")
TINY = preset("vit_t16", image_size=32, patch_size=4)
SMOKE = str(REPO / "recipes" / "smoke_cpu.yaml")


def port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def _blocked_interpreter(body: str, timeout: int = 120) -> subprocess.CompletedProcess:
    """Run ``body`` in a fresh interpreter where importing JAX, the JAX
    package, PyYAML, PIL or cv2 raises."""
    code = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN + OPTIONAL!r}:\n"
        "    sys.modules[name] = None  # any import of it now raises\n"
        + body
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN + OPTIONAL!r}:\n"
        "    sys.modules[name] = None  # any import of it now raises\n"
        f"for mod in {port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "from jumbo_mae_tpu_tpu_torch.ops import _build\n"
        "assert _build._LIBS == {}, 'a kernel library was loaded at import'\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_cli_train_runs_without_jax_yaml_pil_or_cv2(tmp_path):
    res = _blocked_interpreter(
        "from jumbo_mae_tpu_tpu_torch.cli.train import main\n"
        f"main(['--config', 'recipes/smoke_cpu.yaml', '--device', 'cpu', '--set', 'run.output_dir={tmp_path}'])\n"
        "from jumbo_mae_tpu_tpu_torch.data import decode, transforms\n"
        "print('backends', decode.backend(), transforms.backend())\n",
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[train] done:" in res.stdout and "backends none none" in res.stdout
    assert (tmp_path / "smoke_cpu" / "ckpt" / "last" / "10" / "COMMIT").is_file()


def test_a_save_is_served_without_jax_yaml_pil_or_cv2(tmp_path):
    """A smoke pretraining save, then cli.predict (features, the cached
    reconstruction, int8) and extract_features over it, in an
    interpreter where JAX, PyYAML, PIL and cv2 cannot import."""
    res = _blocked_interpreter(
        "from jumbo_mae_tpu_tpu_torch.cli import predict, train\n"
        "from jumbo_mae_tpu_tpu_torch.tools import extract_features\n"
        "import numpy as np\n"
        f"out = {str(tmp_path)!r}\n"
        f"train.main(['--config', {SMOKE!r}, '--device', 'cpu', '--set', 'run.output_dir=' + out])\n"
        "ck = out + '/smoke_cpu/ckpt'\n"
        f"base = ['--config', {SMOKE!r}, '--ckpt', ck, '--synthetic', '3', '--device', 'cpu']\n"
        "f = np.load(predict.main(base + ['--task', 'features', '--quant', 'int8', '--out', out + '/f.npz']))\n"
        "r = np.load(predict.main(base + ['--task', 'reconstruct', '--encoder-cache', '4', '--out', out + '/r.npz']))\n"
        f"e = np.load(extract_features.main([{SMOKE!r}, '--ckpt', ck, '--device', 'cpu', '--out', out + '/e.npz']))\n"
        "print('shapes', f['features'].shape, r['reconstruction'].shape, e['features'].shape)\n",
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "shapes (3, 192) (3, 64, 48) (64, 192)" in res.stdout, res.stdout[-2000:]


def test_replicated_packed_serving_without_jax_yaml_pil_or_cv2(tmp_path):
    """The replica pool, the continuous scheduler and the packed path
    (``cli.predict --serve --replicas 2 --pack``), and one hot swap
    through the controller, in an interpreter where JAX, PyYAML, PIL and
    cv2 cannot import."""
    res = _blocked_interpreter(
        "import numpy as np\n"
        "from jumbo_mae_tpu_tpu_torch.cli import predict\n"
        "from jumbo_mae_tpu_tpu_torch.config import load_config\n"
        "from jumbo_mae_tpu_tpu_torch.infer import InferenceEngine, ReplicaSet, WeightSwapController\n"
        f"out = {str(tmp_path)!r}\n"
        f"f = np.load(predict.main(['--config', {SMOKE!r}, '--synthetic', '6', '--device', 'cpu', '--task', "
        "'features', '--serve', '--replicas', '2', '--pack', '--pack-resolutions', '32:1,16:1', '--warmup', "
        "'--out', out + '/p.npz']))\n"
        f"cfg = load_config({SMOKE!r})\n"
        "rs = ReplicaSet(lambda i: InferenceEngine(cfg, max_batch=2, device='cpu'),\n"
        "                lambda e, b, m: e.features(b), replicas=2, max_batch=2)\n"
        "tree = {n: t.clone() for n, t in rs.replica(0).engine.model('features').state_dict().items()}\n"
        "ctl = WeightSwapController(rs, restore_fn=lambda p: (tree, None), canary_requests=0)\n"
        "rep = ctl.swap('same')\n"
        "rs.close()\n"
        "print('served', f['features'].shape, rep['verdict'])\n",
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "served (6, 192) promoted" in res.stdout, res.stdout[-2000:]


def test_batch_job_and_warm_restart_without_jax_yaml_pil_or_cv2(tmp_path):
    """A stub ``cli.batch`` job over two shards and its ``batch_doctor``
    audit, and the warm-cache probe run twice (the second loads every
    task), in an interpreter where JAX, PyYAML, PIL and cv2 cannot
    import."""
    res = _blocked_interpreter(
        "from jumbo_mae_tpu_tpu_torch.cli import batch\n"
        "from jumbo_mae_tpu_tpu_torch.data.tario import write_tar_samples\n"
        "from jumbo_mae_tpu_tpu_torch.infer import warmcache\n"
        "from jumbo_mae_tpu_tpu_torch.tools import batch_doctor\n"
        f"out = {str(tmp_path)!r}\n"
        "shards = [out + f'/s{i}.tar' for i in range(2)]\n"
        "for i, u in enumerate(shards):\n"
        "    write_tar_samples(u, [{'__key__': f'k{i}{j}', 'bin': bytes([i, j]) * 8} for j in range(5)])\n"
        "rc = batch.main([*shards, '--out', out + '/job', '--service-overhead-ms', '0'])\n"
        "doc = batch_doctor.main([out + '/job', '--out', out + '/doctor.md'])\n"
        "argv = ['--dir', out + '/wc', '--device', 'cpu', '--max-batch', '2']\n"
        "cold, warm = warmcache._probe_main(argv), warmcache._probe_main(argv)\n"
        "print('batch', rc, doc, 'warm', cold['warm_hits'], warm['warm_hits'])\n",
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "batch 0 0 warm 0 1" in res.stdout, res.stdout[-2000:]


def test_billing_and_publishing_without_jax_yaml_pil_or_cv2(tmp_path):
    """A budgeted stub ``cli.batch`` job audited by ``cost_doctor``, a
    training run publishing into a directory audited by
    ``publish_doctor``, and ``cli.predict`` with tenants, the autoscaler
    and the access log, in an interpreter where JAX, PyYAML, PIL and cv2
    cannot import."""
    res = _blocked_interpreter(
        "import json\n"
        "from jumbo_mae_tpu_tpu_torch.cli import batch, predict, train\n"
        "from jumbo_mae_tpu_tpu_torch.data.tario import write_tar_samples\n"
        "from jumbo_mae_tpu_tpu_torch.tools import cost_doctor, publish_doctor\n"
        f"out = {str(tmp_path)!r}\n"
        "write_tar_samples(out + '/s.tar', [{'__key__': f'k{j}', 'bin': bytes([j]) * 8} for j in range(6)])\n"
        "rc = batch.main([out + '/s.tar', '--out', out + '/job', '--tenants', 'batch=batch:budget=1:window=5'])\n"
        "cost = cost_doctor.main([out + '/job/access', '--out', out + '/cost.md'])\n"
        f"train.main(['--config', {SMOKE!r}, '--device', 'cpu', '--set', 'run.output_dir=' + out,\n"
        "            'run.training_steps=2', 'run.ckpt_every=2', 'run.publish_dir=' + out + '/pub'])\n"
        "pub = publish_doctor.main([out + '/pub'])\n"
        f"predict.main(['--config', {SMOKE!r}, '--synthetic', '6', '--device', 'cpu', '--task', 'features',\n"
        "              '--serve', '--replicas', '1', '--tenants', 'a=batch', '--autoscale', '1:2',\n"
        "              '--access-log', out + '/acc', '--out', out + '/f.npz'])\n"
        "print('billing', rc, cost, pub)\n",
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "billing 0 0 0" in res.stdout and "pool served 6/6 ok" in res.stdout, res.stdout[-2000:]


def test_telemetry_without_jax_yaml_pil_or_cv2(tmp_path):
    """``cli.predict --serve --replicas 2 --warmup --metrics-port 0 --slo
    ... --access-log``, its ``/metrics`` and ``/healthz`` read over
    loopback during ``--metrics-hold-s``, and ``serve_doctor`` over its
    access log, in an interpreter where JAX, PyYAML, PIL and cv2 cannot
    import."""
    res = _blocked_interpreter(
        "import json, threading, time, urllib.request\n"
        "from jumbo_mae_tpu_tpu_torch.cli import predict\n"
        "from jumbo_mae_tpu_tpu_torch.obs import exporter\n"
        "from jumbo_mae_tpu_tpu_torch.tools import serve_doctor\n"
        f"out = {str(tmp_path)!r}\n"
        "servers = []\n"
        "class Recorded(exporter.TelemetryServer):\n"
        "    def start(self):\n"
        "        servers.append(super().start())\n"
        "        return self\n"
        "exporter.TelemetryServer = Recorded\n"
        f"argv = ['--config', {SMOKE!r}, '--synthetic', '6', '--device', 'cpu', '--task', 'features', '--serve',\n"
        "        '--replicas', '2', '--warmup', '--metrics-port', '0', '--slo', 'success_rate>=0.5',\n"
        "        '--access-log', out + '/acc', '--metrics-hold-s', '3', '--out', out + '/f.npz']\n"
        "t = threading.Thread(target=predict.main, args=(argv,))\n"
        "t.start()\n"
        "deadline = time.monotonic() + 120\n"
        "while not servers and time.monotonic() < deadline:\n"
        "    time.sleep(0.01)\n"
        "url = f'http://127.0.0.1:{servers[0].port}'\n"
        "text = ''\n"
        "while 'infer_requests_total 6' not in text and time.monotonic() < deadline:\n"
        "    text = urllib.request.urlopen(url + '/metrics', timeout=10).read().decode()\n"
        "    time.sleep(0.05)\n"
        "health = json.loads(urllib.request.urlopen(url + '/healthz', timeout=10).read().decode())\n"
        "t.join(timeout=120)\n"
        "rc = serve_doctor.main([out + '/acc', '--out', out + '/serve.md'])\n"
        "print('telemetry', 'infer_requests_total 6' in text, health['ready'], rc)\n",
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "telemetry True True 0" in res.stdout and "pool served 6/6 ok" in res.stdout, res.stdout[-2000:]


def test_figure_and_msgpack_without_jax_yaml_pil_cv2_or_msgpack(tmp_path):
    """A smoke pretraining run with the "dots" remat policy, its save
    exported as a flax ``.msgpack`` and read back, served from the
    ``.msgpack`` by ``cli.predict``, and the reconstruction figure drawn
    from it (a PNG of the expected size), in an interpreter where JAX,
    PyYAML, PIL, cv2 and msgpack cannot import."""
    res = _blocked_interpreter(
        "import numpy as np, struct\n"
        "from jumbo_mae_tpu_tpu_torch.cli import predict, train\n"
        "from jumbo_mae_tpu_tpu_torch.cli.train import build_model\n"
        "from jumbo_mae_tpu_tpu_torch.config import load_config\n"
        "from jumbo_mae_tpu_tpu_torch.interop.from_jax import model_flax_tree\n"
        "from jumbo_mae_tpu_tpu_torch.tools import reconstruct\n"
        "from jumbo_mae_tpu_tpu_torch.train import checkpoint as ck\n"
        f"out = {str(tmp_path)!r}\n"
        "dots = 'model.overrides={mask_ratio: 0.75, posemb: sincos2d, image_size: 32, patch_size: 4, '\\\n"
        "       'dtype: float32, grad_ckpt: true, remat_policy: dots}'\n"
        f"train.main(['--config', {SMOKE!r}, '--device', 'cpu', '--set', 'run.output_dir=' + out,\n"
        "            'run.training_steps=2', dots])\n"
        f"model, _, _ = build_model(load_config({SMOKE!r}), device='cpu')\n"
        "model.load_state_dict(ck.read_state(out + '/smoke_cpu/ckpt')['model'])\n"
        "ck.export_params_msgpack(model_flax_tree(model)[0], out + '/p.msgpack')\n"
        "params, _ = ck.restore_inference_state(out + '/p.msgpack')\n"
        "same = all(np.array_equal(params[n].numpy(), t.numpy()) for n, t in model.state_dict().items())\n"
        f"f = np.load(predict.main(['--config', {SMOKE!r}, '--ckpt', out + '/p.msgpack', '--synthetic', '3',\n"
        "                           '--device', 'cpu', '--task', 'features', '--out', out + '/f.npz']))\n"
        f"png = reconstruct.main([{SMOKE!r}, '--ckpt', out + '/p.msgpack', '--out', out + '/r.png', '--n', '2',\n"
        "                         '--device', 'cpu', '--set', 'run.synthetic_data=true'])\n"
        "w, h = struct.unpack('>II', open(png, 'rb').read()[16:24])\n"
        "print('figure', same, f['features'].shape, w, h)\n",
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "figure True (3, 192) 134 66" in res.stdout, res.stdout[-2000:]


def test_images_without_cv2_or_pil_raise_naming_both(tmp_path):
    """With neither cv2 nor PIL, decoding a JPEG, resizing and starting a
    train loader raise ImportError naming both packages; nothing returns
    an array or skips the sample."""
    from PIL import Image

    jpg = tmp_path / "x.jpg"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(jpg)
    res = _blocked_interpreter(
        "import numpy as np\n"
        "from jumbo_mae_tpu_tpu_torch.data import decode, transforms\n"
        "from jumbo_mae_tpu_tpu_torch.data.loader import DataConfig, TrainLoader\n"
        f"payload = open({str(jpg)!r}, 'rb').read()\n"
        "calls = {'decode': lambda: decode.decode_image(payload),\n"
        "         'resize': lambda: transforms.resize(np.zeros((4, 4, 3), np.uint8), (2, 2)),\n"
        "         'loader': lambda: TrainLoader(DataConfig(train_shards='s-{0000..0003}.tar', workers=0), 4)}\n"
        "for name, call in calls.items():\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        print(name, 'raised:', e)\n"
        "    else:\n"
        "        print(name, 'did not raise')\n"
    )
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert [ln.split()[0] for ln in lines] == ["decode", "resize", "loader"]
    for ln in lines:
        assert "raised:" in ln and "cv2" in ln and "PIL" in ln, ln


def test_augment_policy_without_pil_raises_naming_it(tmp_path):
    """RandAugment needs PIL: with it blocked, asking for a policy (or a
    loader with one) raises ImportError naming PIL; no policy needs none."""
    res = _blocked_interpreter(
        "from jumbo_mae_tpu_tpu_torch.data import randaugment\n"
        "from jumbo_mae_tpu_tpu_torch.data.loader import DataConfig, TrainTransform\n"
        "assert randaugment.auto_augment_factory('none') is None\n"
        "TrainTransform(DataConfig())\n"
        "for call in (lambda: randaugment.auto_augment_factory('rand-m9-mstd0.5-inc1'),\n"
        "             lambda: TrainTransform(DataConfig(auto_augment='augmix-m3'))):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        print('raised:', e)\n"
        "    else:\n"
        "        print('did not raise')\n"
    )
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 2 and all("raised:" in ln and "PIL" in ln for ln in lines), lines


def test_module_list_covers_the_slice():
    mods = set(port_modules())
    for m in (
        "jumbo_mae_tpu_tpu_torch.ops.posemb",
        "jumbo_mae_tpu_tpu_torch.ops.preprocess",
        "jumbo_mae_tpu_tpu_torch.ops.flash.attention",
        "jumbo_mae_tpu_tpu_torch.ops.flash_attention",
        "jumbo_mae_tpu_tpu_torch.models.config",
        "jumbo_mae_tpu_tpu_torch.models.layers",
        "jumbo_mae_tpu_tpu_torch.models.vit",
        "jumbo_mae_tpu_tpu_torch.interop.from_jax",
        "jumbo_mae_tpu_tpu_torch.infer.bucketing",
        "jumbo_mae_tpu_tpu_torch.infer.engine",
        "jumbo_mae_tpu_tpu_torch.cli.predict",
        "jumbo_mae_tpu_tpu_torch.ops.patches",
        "jumbo_mae_tpu_tpu_torch.ops.masking",
        "jumbo_mae_tpu_tpu_torch.models.mae",
        "jumbo_mae_tpu_tpu_torch.obs.mfu",
        "jumbo_mae_tpu_tpu_torch.data.synthetic",
        "jumbo_mae_tpu_tpu_torch.train.optim",
        "jumbo_mae_tpu_tpu_torch.train.state",
        "jumbo_mae_tpu_tpu_torch.train.steps",
        "jumbo_mae_tpu_tpu_torch.parallel",
        "jumbo_mae_tpu_tpu_torch.parallel.mesh",
        "jumbo_mae_tpu_tpu_torch.parallel.distributed",
        "jumbo_mae_tpu_tpu_torch.parallel.ring_attention",
        "jumbo_mae_tpu_tpu_torch.config",
        "jumbo_mae_tpu_tpu_torch.data.shards",
        "jumbo_mae_tpu_tpu_torch.data.tario",
        "jumbo_mae_tpu_tpu_torch.data.resize",
        "jumbo_mae_tpu_tpu_torch.data.decode",
        "jumbo_mae_tpu_tpu_torch.data.transforms",
        "jumbo_mae_tpu_tpu_torch.data.loader",
        "jumbo_mae_tpu_tpu_torch.data._worker",
        "jumbo_mae_tpu_tpu_torch.data.toy",
        "jumbo_mae_tpu_tpu_torch.train.checkpoint",
        "jumbo_mae_tpu_tpu_torch.train.engine",
        "jumbo_mae_tpu_tpu_torch.utils.logging",
        "jumbo_mae_tpu_tpu_torch.utils.meters",
        "jumbo_mae_tpu_tpu_torch.utils.summary",
        "jumbo_mae_tpu_tpu_torch.cli.train",
        "jumbo_mae_tpu_tpu_torch.ops.mixup",
        "jumbo_mae_tpu_tpu_torch.models.classifier",
        "jumbo_mae_tpu_tpu_torch.data.randaugment",
        "jumbo_mae_tpu_tpu_torch.infer.quant",
        "jumbo_mae_tpu_tpu_torch.infer.batching",
        "jumbo_mae_tpu_tpu_torch.tools",
        "jumbo_mae_tpu_tpu_torch.tools.extract_features",
        "jumbo_mae_tpu_tpu_torch.tools.knn_probe",
        "jumbo_mae_tpu_tpu_torch.infer.packing",
        "jumbo_mae_tpu_tpu_torch.infer.replicaset",
        "jumbo_mae_tpu_tpu_torch.obs.slo",
        "jumbo_mae_tpu_tpu_torch.serve",
        "jumbo_mae_tpu_tpu_torch.serve.admission",
        "jumbo_mae_tpu_tpu_torch.serve.scheduler",
        "jumbo_mae_tpu_tpu_torch.obs",
        "jumbo_mae_tpu_tpu_torch.obs.metrics",
        "jumbo_mae_tpu_tpu_torch.obs.journal",
        "jumbo_mae_tpu_tpu_torch.obs.doctor_common",
        "jumbo_mae_tpu_tpu_torch.infer.warmcache",
        "jumbo_mae_tpu_tpu_torch.faults",
        "jumbo_mae_tpu_tpu_torch.faults.inject",
        "jumbo_mae_tpu_tpu_torch.batch",
        "jumbo_mae_tpu_tpu_torch.batch.leases",
        "jumbo_mae_tpu_tpu_torch.batch.partfile",
        "jumbo_mae_tpu_tpu_torch.batch.job",
        "jumbo_mae_tpu_tpu_torch.cli.batch",
        "jumbo_mae_tpu_tpu_torch.tools.batch_doctor",
        "jumbo_mae_tpu_tpu_torch.obs.perfmodel",
        "jumbo_mae_tpu_tpu_torch.obs.costmodel",
        "jumbo_mae_tpu_tpu_torch.obs.reqtrace",
        "jumbo_mae_tpu_tpu_torch.serve.costmeter",
        "jumbo_mae_tpu_tpu_torch.serve.autoscaler",
        "jumbo_mae_tpu_tpu_torch.serve.publisher",
        "jumbo_mae_tpu_tpu_torch.tools.publish_doctor",
        "jumbo_mae_tpu_tpu_torch.tools.cost_doctor",
        "jumbo_mae_tpu_tpu_torch.obs.lockwatch",
        "jumbo_mae_tpu_tpu_torch.obs.exporter",
        "jumbo_mae_tpu_tpu_torch.obs.memwatch",
        "jumbo_mae_tpu_tpu_torch.obs.retrace",
        "jumbo_mae_tpu_tpu_torch.tools.serve_doctor",
        "jumbo_mae_tpu_tpu_torch.tools.mem_doctor",
        "jumbo_mae_tpu_tpu_torch.ops.blockwise_attention",
        "jumbo_mae_tpu_tpu_torch.data.valcache",
        "jumbo_mae_tpu_tpu_torch.data.native",
        "jumbo_mae_tpu_tpu_torch.interop.flax_msgpack",
        "jumbo_mae_tpu_tpu_torch.interop.torch_convert",
        "jumbo_mae_tpu_tpu_torch.interop.reference_convert",
        "jumbo_mae_tpu_tpu_torch.tools.reconstruct",
    ):
        assert m in mods
    for src in ("flash_fwd.cu", "flash_bwd.cu", "flash_common.cuh"):
        assert (PORT / "csrc" / src).exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(load_config(SMOKE))
    # the explicit CPU request works
    assert InferenceEngine(load_config(SMOKE), device="cpu", max_batch=2).device.type == "cpu"


def test_model_and_cli_default_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        JumboViT(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.main(["--config", SMOKE, "--synthetic", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):  # the replicas' engines too
        predict.main(["--config", SMOKE, "--synthetic", "1", "--serve", "--replicas", "2", "--pack"])
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_features.main([SMOKE, "--out", "unused.npz"])
    with pytest.raises(RuntimeError, match="CUDA"):
        knn_probe.main([SMOKE, SMOKE, "--set", "run.mode=finetune"])
    from jumbo_mae_tpu_tpu_torch.cli import batch
    from jumbo_mae_tpu_tpu_torch.infer import warmcache

    with pytest.raises(RuntimeError, match="CUDA"):  # the job's replicas
        batch.main(["shard.tar", "--out", "unused", "--config", SMOKE])
    with pytest.raises(RuntimeError, match="CUDA"):
        warmcache._probe_main(["--dir", "unused"])
    with pytest.raises(RuntimeError, match="CUDA"):  # tenants, autoscaler: the engines first
        predict.main(["--config", SMOKE, "--synthetic", "1", "--serve", "--replicas", "1", "--tenants", "a=batch",
                      "--autoscale", "1:2"])
    from jumbo_mae_tpu_tpu_torch.obs.perfmodel import detect_chip
    from jumbo_mae_tpu_tpu_torch.serve import roofline_capacity

    with pytest.raises(RuntimeError, match="CUDA"):  # the model never prices the card as a CPU
        detect_chip()
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline_capacity(1e9, 1e6)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_default_to_cuda(no_cuda):
    from jumbo_mae_tpu_tpu_torch.models import DecoderConfig
    from jumbo_mae_tpu_tpu_torch.models.mae import MAEPretrainModel
    from jumbo_mae_tpu_tpu_torch.train.optim import OptimConfig
    from jumbo_mae_tpu_tpu_torch.train.steps import create_state

    enc = TINY.replace(labels=None, mask_ratio=0.75)
    dec = DecoderConfig(layers=1, dim=32, heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MAEPretrainModel(enc, dec)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_state((enc, dec), OptimConfig(), global_batch_size=2)
    assert create_state((enc, dec), OptimConfig(), device="cpu", global_batch_size=2).device.type == "cpu"


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Run without a card, chip_smoke.py exits non-zero and prints no
    result line — here and in a directory holding nothing but itself."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        res = subprocess.run(
            [sys.executable, str(script)], cwd=str(cwd), env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
