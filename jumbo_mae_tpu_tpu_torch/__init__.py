"""jumbo_mae_tpu_tpu_torch — the PyTorch/CUDA port of ``jumbo_mae_tpu_tpu``.

The port runs on an NVIDIA H100. Its module paths mirror the JAX
package's, so each module here has its counterpart at the same path there.
The JAX package stays the numerical reference; this package never imports
it, nor JAX itself, and keeps its own copy of everything it needs.

Ported so far: the serving path — ``cli/predict.py`` → ``infer/engine.py``
→ ``models/vit.py``; the MAE pretraining step — ``train/steps.py`` →
``models/mae.py``; data and sequence parallelism — ``parallel/`` (ring
attention). Attention runs in hand-written CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, bound in
``ops/flash/attention.py``).
Every entry point runs on ``"cuda"`` unless the caller passes
``device="cpu"``; without a CUDA device it raises instead of carrying on.
"""

__version__ = "0.1.0"
