"""Worker processes of tests/test_torch_distributed.py: the port's train
CLI as one process of a ``--distributed`` group (or alone).

    python tests/torch_cli_workers.py OUT [--sigterm-at STEP] -- ARGV...

runs ``jumbo_mae_tpu_tpu_torch.cli.train.main(ARGV)`` and ``torch.save``s
to ``OUT``: the exit code, the metrics ``train()`` returned, the train
batches this process stepped on (host copies, in step order), the final
state's tensors, step and seed, and the error of a run that raised.
``--sigterm-at STEP`` sends this process a SIGTERM when step ``STEP`` has
been dispatched, as a preemption notice to this process alone would.
"""

from __future__ import annotations

import os
import signal
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from jumbo_mae_tpu_tpu_torch.cli import train as ttrain  # noqa: E402


def _host(v) -> np.ndarray:
    return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).copy()


def main(out: str, sigterm_at: int | None, argv: list[str]) -> int:
    rec: dict = {"batches": [], "metrics": None, "state": None, "error": None, "exit_code": 0}
    make_iter, run_train = ttrain.make_train_iterator, ttrain.train

    def teed(*a, **kw):
        it, source, cursor_log, shard_log = make_iter(*a, **kw)

        def gen():
            for b in it:
                rec["batches"].append({k: _host(v) for k, v in b.items()})
                yield b

        return gen(), source, cursor_log, shard_log

    class Engine(ttrain.RunEngine):
        def __init__(self, **kw):
            super().__init__(**kw)
            if sigterm_at is not None:
                self.on_step(lambda eng, ev: os.kill(os.getpid(), signal.SIGTERM) if ev.step == sigterm_at else None)

        def run(self, state):
            try:
                return super().run(state)
            finally:
                st = self.state
                rec["state"] = {"model": {k: v.detach().clone() for k, v in st.model.state_dict().items()},
                                "step": int(st.step), "seed": int(st.seed)}

    def recorded(cfg, **kw):
        out = run_train(cfg, **kw)
        rec["metrics"] = dict(out)  # main pops the exit reason from what it gets
        return out

    ttrain.make_train_iterator, ttrain.RunEngine, ttrain.train = teed, Engine, recorded
    try:
        ttrain.main(argv)
    except SystemExit as e:
        rec["exit_code"] = int(e.code or 0)
    except Exception as e:  # noqa: BLE001 - recorded for the test to read
        rec["error"], rec["exit_code"] = f"{type(e).__name__}: {e}", 1
    torch.save(rec, out)
    return rec["exit_code"]


if __name__ == "__main__":
    args = sys.argv[1:]
    cut = args.index("--")
    opts, argv = args[:cut], args[cut + 1:]
    at = int(opts[opts.index("--sigterm-at") + 1]) if "--sigterm-at" in opts else None
    sys.exit(main(opts[0], at, argv))
