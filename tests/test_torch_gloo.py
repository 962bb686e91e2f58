"""The port under real process groups: two gloo processes on the CPU.

- seq = 2: ``ProcessGroupRing`` (point-to-point rotation over the ``seq``
  subgroup, the chunk taken and the output gathered by autograd Functions
  of their own) gives the forward and the gradients of ``StackedRing(2)``
  in one process, on both inners and on an uneven length; float32 at
  atol/rtol 1e-6 (the same arithmetic over another batch folding).
- data = 2: two MAE steps with each rank on its half of the global batch,
  gradients averaged over the data group, equal one process on the global
  batch: loss at rtol 1e-6 (a mean of two means against one mean), and
  parameters at 1e-2 of the learning rate (attention key biases, whose
  true gradient is zero, within Adam's bound of one learning rate per
  step), as in tests/test_torch_train.py. DropPath and per-sample masks
  are on, so the draws for the global batch are checked too; a second
  job adds dropout 0.1 at every site (the einsum path).

Each job runs ``tests/torch_gloo_workers.py`` in two subprocesses that
meet through a ``FileStore`` in the test's temporary directory, with a
time limit; together the three jobs take about 11 s on a CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import torch_gloo_workers as workers
from jumbo_mae_tpu_tpu_torch.parallel import MeshConfig, create_mesh

HERE = Path(__file__).resolve().parent
TIMEOUT_S = 120


def run_job(job: str, tmp_path: Path, world: int = 2) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(HERE.parent), str(HERE)]), OMP_NUM_THREADS="2")
    outs = [tmp_path / f"{job}{r}.pt" for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "torch_gloo_workers.py"), job, str(r), str(world),
             str(tmp_path / f"{job}.store"), str(outs[r])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(o) for o in outs]


def test_process_group_ring_equals_stacked_ring(tmp_path):
    ranks = run_job("ring", tmp_path)
    want = workers.ring_results(
        create_mesh(MeshConfig(data=1, fsdp=1, seq=2), device="cpu", one_process_seq=True)
    )
    assert set(want) == set(ranks[0]) == set(ranks[1])
    for case, ref in want.items():
        for got in ranks:
            for name, g, r in zip(("out", "dq", "dk", "dv"), got[case], ref):
                torch.testing.assert_close(g, r, atol=1e-6, rtol=1e-6, msg=f"{case} {name}")
        # every seq rank holds the whole output and the whole gradients
        assert all(torch.equal(a, b) for a, b in zip(ranks[0][case], ranks[1][case]))


def check_data_parallel(ranks, want) -> None:
    lr = workers.OPT.learning_rate
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        for n, p in want["params"].items():
            atol = 2 * workers.STEPS * lr if n.endswith("attn.k.bias") else 1e-2 * lr
            torch.testing.assert_close(got["params"][n], p, atol=atol, rtol=0, msg=n)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in want["params"])


def test_data_parallel_step_equals_one_process(tmp_path):
    check_data_parallel(run_job("data", tmp_path), workers.step_results((0, 1)))


def test_data_parallel_step_with_dropout_equals_one_process(tmp_path):
    """Dropout 0.1 at every site, on the einsum path: each data rank keeps
    its rows of masks drawn for the global batch from the step's stream,
    so two ranks take the steps of one process on the global batch."""
    want = workers.step_results((0, 1), workers.DROPOUT)
    assert want["loss"] != workers.step_results((0, 1))["loss"]  # the masks are drawn
    check_data_parallel(run_job("data_dropout", tmp_path), want)
