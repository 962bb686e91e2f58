"""What each program costs: FLOPs, bytes and memory per execution.

Counterpart of ``jumbo_mae_tpu_tpu/obs/costmodel.py``. The JAX module
reads XLA's own accounting off a compiled executable
(``cost_analysis()``/``memory_analysis()``). The port has no compiler to
ask: a CUDA graph is a recording of kernel launches, and the train step
runs eagerly. So the port builds each :class:`ProgramCost` from the model
instead.

:func:`program_cost` prices one captured serving ``(task key, bucket)``
graph:

- ``flops`` — the analytic counts of ``obs/mfu.py``: the full-sequence
  encoder times the bucket; plus the head for ``logits``; the masked
  encoder plus the decoder for ``reconstruct`` (``reconstruct.enc`` and
  ``reconstruct.dec`` are the two halves);
- ``bytes_accessed`` — the weights' bytes in the serving dtype (int8
  weights as stored) plus ``2·flops/dim``, the activation model the JAX
  CLI prices its autoscaler with;
- ``peak_bytes`` — the graph's memory-pool growth at its capture
  (``InferenceEngine.graph_stats()["pool_bytes"]``).

:func:`train_step_cost` prices one train step (the JAX CLI's
``compiled_program`` row of ``train_step``):

- ``flops`` — :func:`train_step_flops`: the analytic training FLOPs of
  ``obs/mfu.py`` times the batch, plus the recompute that ``grad_ckpt``
  adds under the stack's ``remat_policy`` (``models/config.py``
  ``checkpoint_policy``): ``"none"`` runs every checkpointed block's
  forward again; ``"dots"`` runs again what is not a saved matmul, among
  it the attention scores wherever they go through the flash kernels (K1
  is no matmul to the policy, as a Pallas call is none to XLA's);
  ``"dots_no_batch"`` also the attention einsums, whose matmuls have a
  batch dimension. A linear probe's frozen trunk runs its forward only;
- ``bytes_accessed`` — each forward (the recompute's included) and the
  backward read the weights once, the gradients are written and read
  once, the optimizer reads and writes its state and the parameters, and
  the activations move ``2·flops/dim`` (the serving model's);
- ``peak_bytes`` — ``torch.cuda.max_memory_allocated()`` over the first
  log window on the card (the CLI resets the statistics as its step loop
  starts); ``None`` on the CPU.

The argument, output, temp and generated-code sizes cannot be known and
are ``None``; ``source`` is ``"analytic"``. :func:`lookup_cost`,
:func:`publish_cost` and :func:`utilization_report` are the JAX
functions. The gauges keep the JAX family names (``xla_flops``…), so a
dashboard reads either package; an unknown field sets no gauge.

MFU counts the model's FLOPs and HFU the FLOPs the program runs. For a
serving graph the two counts are one. For the train step HFU counts the
recompute too, so HFU ≥ MFU under ``grad_ckpt``, and the gap is the
recompute's bill (ViT-L/16 MAE under ``"none"``: 1.25×).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from jumbo_mae_tpu_tpu_torch.obs.mfu import (
    _attention_flops,
    _mlp_flops,
    classify_flops_per_image,
    decoder_flops_per_image,
    encoder_flops_per_image,
    pretrain_flops_per_image,
)

# Bump when the ProgramCost field set changes: journal events carry it.
COST_SCHEMA_VERSION = 1


@dataclass
class ProgramCost:
    """One program's cost per execution; ``None`` = not known."""

    program: str
    flops: float = 0.0
    bytes_accessed: float = 0.0
    argument_bytes: float | None = None
    output_bytes: float | None = None
    temp_bytes: float | None = None
    peak_bytes: float | None = None
    generated_code_bytes: float | None = None
    source: str = "analytic"


def _embed_flops(cfg) -> float:
    return 2 * cfg.num_patches * cfg.dim * (cfg.patch_size**2 * 3)


def task_flops(task_key: str, bucket: int, enc_cfg, dec_cfg=None, labels: int | None = None) -> float | None:
    """Analytic FLOPs of one execution of an engine graph: ``task_key``
    as ``InferenceEngine`` names it (``features:cls``, ``logits``,
    ``reconstruct``, ``reconstruct.enc``/``.dec``, the per-resolution
    ``<task>.full:<pool>@<res>`` and ``<task>.embed@<res>``, the packed
    ``<task>.packed:<pool>@r<rows>s<segments>`` whose bucket is its
    token budget a row). ``None`` for a key this model does not know."""
    head = 2 * enc_cfg.num_cls_tokens * enc_cfg.dim * (labels or 0)
    task, _, rest = task_key.partition(".")
    task = task.split(":", 1)[0]
    if not rest:
        if task == "features":
            return encoder_flops_per_image(enc_cfg, masked=False) * bucket
        if task == "logits":
            return (encoder_flops_per_image(enc_cfg, masked=False) + head) * bucket
        if task == "reconstruct" and dec_cfg is not None:
            return (encoder_flops_per_image(enc_cfg, masked=True) + decoder_flops_per_image(enc_cfg, dec_cfg)) * bucket
        return None
    if rest == "enc":
        return encoder_flops_per_image(enc_cfg, masked=True) * bucket
    if rest == "dec" and dec_cfg is not None:
        return decoder_flops_per_image(enc_cfg, dec_cfg) * bucket
    at = rest.rpartition("@")[2]
    if rest.startswith("embed@"):
        return _embed_flops(enc_cfg.replace(image_size=int(at))) * bucket
    if rest.startswith("full:"):
        per = encoder_flops_per_image(enc_cfg.replace(image_size=int(at)), masked=False)
        return (per + (head if task == "logits" else 0)) * bucket
    if rest.startswith("packed:"):
        # ``rows`` packed rows of ``bucket`` tokens each (the budget): the
        # blocks over every token and attention over each row's full
        # length (the masked einsum builds every score); the embeddings
        # are graphs of their own
        rows = int(at[1:].split("s")[0])
        d, tokens = enc_cfg.dim, rows * bucket
        per_layer = (4 * 2 * tokens * d * d + 2 * 2 * rows * bucket * bucket * d
                     + 2 * 2 * tokens * d * enc_cfg.hidden_dim)
        return enc_cfg.layers * per_layer
    return None


def weight_bytes(model, compute_dtype) -> float:
    """The bytes a forward reads of ``model``'s weights: each floating
    tensor at the serving dtype's width, int8 weights as stored."""
    import torch

    width = torch.empty((), dtype=compute_dtype).element_size()
    return float(sum(t.numel() * (width if t.is_floating_point() else t.element_size())
                     for t in model.state_dict().values()))


def program_cost(program: str, *, flops: float, weight_nbytes: float, dim: int,
                 peak_bytes: float | None = None) -> ProgramCost:
    """The :class:`ProgramCost` of one graph: ``bytes_accessed`` is the
    weights' bytes plus the activation model ``2·flops/dim``."""
    return ProgramCost(program=program, flops=float(flops),
                       bytes_accessed=float(weight_nbytes) + 2.0 * float(flops) / max(dim, 1),
                       peak_bytes=None if peak_bytes is None else float(peak_bytes))


def _runs_flash(cfg, head_dim: int, device_type: str) -> bool:
    """Whether a block stack's attention goes through the flash kernels
    in a training forward (``models/layers.py`` ``resolve_attn_impl``)."""
    from jumbo_mae_tpu_tpu_torch.models.layers import resolve_attn_impl

    impl = resolve_attn_impl(cfg.attn_impl, device_type=device_type, dropout=cfg.dropout, deterministic=False,
                             head_dim=head_dim, dtype=cfg.compute_dtype)
    return impl == "flash" or (impl == "ring" and cfg.ring_inner == "flash")


def _recompute_flops_per_image(cfg, seq: int, tokens: int, layers: int, hidden: int, extra_mlp: float,
                              device_type: str) -> float:
    """Matmul FLOPs one image's checkpointed blocks run again in the
    backward: ``seq`` tokens through attention, ``tokens`` through the
    MLP, ``extra_mlp`` FLOPs a block beside (the jumbo MLP). Zero without
    ``grad_ckpt``."""
    if not cfg.grad_ckpt:
        return 0.0
    d = cfg.dim
    scores = 2 * 2 * seq * seq * d
    if cfg.remat_policy == "none":
        return layers * (_attention_flops(seq, d) + _mlp_flops(tokens, d, hidden) + extra_mlp)
    if cfg.remat_policy == "dots_no_batch" or _runs_flash(cfg, d // cfg.heads, device_type):
        return layers * scores
    return 0.0


def train_step_flops(enc_cfg, dec_cfg=None, *, batch: int, linear: bool = False,
                     device_type: str = "cuda") -> float:
    """The FLOPs one train step runs: the analytic training count times
    ``batch`` (MAE pretraining with ``dec_cfg``, else classification),
    plus the checkpoint recompute; a linear probe's trunk runs forward
    only (no backward, no recompute) and its head forward and backward."""
    e = enc_cfg
    jumbo = _mlp_flops(1, e.num_cls_tokens * e.dim, 4 * e.num_cls_tokens * e.dim)
    if dec_cfg is not None:
        seq = e.keep_len + e.num_cls_tokens
        dseq = e.num_patches + e.num_cls_tokens
        per_image = (pretrain_flops_per_image(e, dec_cfg)
                     + _recompute_flops_per_image(e, seq, e.keep_len, e.layers, e.hidden_dim, jumbo, device_type)
                     + _recompute_flops_per_image(dec_cfg, dseq, dseq, dec_cfg.layers, dec_cfg.hidden_dim, 0.0,
                                                 device_type))
    elif linear:
        head = 2 * e.num_cls_tokens * e.dim * (e.labels or 0)
        per_image = encoder_flops_per_image(e, masked=False) + 3 * head
    else:
        seq = e.num_patches + e.num_cls_tokens
        per_image = classify_flops_per_image(e) + _recompute_flops_per_image(
            e, seq, e.num_patches, e.layers, e.hidden_dim, jumbo, device_type)
    return per_image * batch


def train_step_cost(enc_cfg, dec_cfg=None, *, batch: int, param_bytes: float, opt_bytes: float,
                    linear: bool = False, device_type: str = "cuda", peak_bytes: float | None = None
                    ) -> ProgramCost:
    """The :class:`ProgramCost` of one train step (module docstring):
    ``param_bytes`` the parameters' stored bytes, ``opt_bytes`` the
    optimizer state's (moments and master weights)."""
    flops = train_step_flops(enc_cfg, dec_cfg, batch=batch, linear=linear, device_type=device_type)
    ckpt = enc_cfg.grad_ckpt and not linear
    forwards = 2 if ckpt else 1  # the recompute reads the weights again
    backward = 0 if linear else 1
    bytes_accessed = (param_bytes * (forwards + backward) + param_bytes * 2 * backward
                      + (opt_bytes + param_bytes) * 2 + 2.0 * flops / max(enc_cfg.dim, 1))
    return ProgramCost(program="train_step", flops=float(flops), bytes_accessed=float(bytes_accessed),
                       peak_bytes=None if peak_bytes is None else float(peak_bytes))


def cost_asdict(cost: ProgramCost) -> dict:
    """Journal payload of one program's cost."""
    return {"cost_schema": COST_SCHEMA_VERSION, **asdict(cost)}


def lookup_cost(cost_reports, task: str, bucket: int) -> ProgramCost | None:
    """The ``ProgramCost`` of one dispatched ``(task, bucket)``. Tables are
    keyed ``(task_key, bucket)`` where the key may carry a pool the
    dispatcher does not know (the port's engine writes ``"features:cls"``,
    the JAX engine ``"features/mean"``; both are read). Exact key first,
    then a key at the bucket whose task equals or extends ``task``, then
    any key at the bucket (one-task engines); ``None`` when nothing was
    captured at that bucket (the meter then bills device time only)."""
    if not cost_reports:
        return None
    exact = cost_reports.get((task, int(bucket)))
    if exact is not None:
        return exact
    fallback = None
    for (key_task, key_bucket), cost in cost_reports.items():
        if int(key_bucket) != int(bucket):
            continue
        if key_task == task or str(key_task).startswith((f"{task}/", f"{task}:")):
            return cost
        if fallback is None:
            fallback = cost
    return fallback


_GAUGES = (
    ("xla_flops", "flops", "analytic flops per execution"),
    ("xla_bytes_accessed", "bytes_accessed", "weights' bytes plus the activation model per execution"),
    ("xla_peak_bytes", "peak_bytes", "memory-pool growth at the graph's capture"),
    ("xla_argument_bytes", "argument_bytes", "argument buffer bytes"),
    ("xla_output_bytes", "output_bytes", "output buffer bytes"),
    ("xla_temp_bytes", "temp_bytes", "scratch/temp buffer bytes"),
)


def publish_cost(cost: ProgramCost | None, *, bucket: str = "", dtype: str = "", registry=None,
                 journal=None) -> None:
    """Set the ``xla_*{program,bucket,dtype}`` gauges of one program (a
    ``None`` field sets none) and, given a ``journal`` (anything with
    ``event``), write one ``compiled_program`` event. Called once per
    capture, never per dispatch."""
    if cost is None:
        return
    if registry is None:
        from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

        registry = get_registry()
    labels = (cost.program, str(bucket), str(dtype))
    for name, field, help_ in _GAUGES:
        value = getattr(cost, field)
        if value is not None:
            registry.gauge(name, help_, labels=("program", "bucket", "dtype")).labels(*labels).set(value)
    if journal is not None:
        journal.event("compiled_program", bucket=str(bucket), dtype=str(dtype), **cost_asdict(cost))


@dataclass
class UtilizationReport:
    """The MFU/HFU split over one measured steady-state window."""

    model_flops_utilization: float
    hardware_flops_utilization: float
    achieved_model_tflops: float
    achieved_hardware_tflops: float
    peak_tflops: float


def utilization_report(
    analytic_flops_per_step: float,
    xla_flops_per_step: float | None,
    steps_per_sec: float,
    *,
    n_chips: int = 1,
    peak_tflops: float | None = None,
) -> UtilizationReport:
    """MFU (analytic FLOPs) and HFU (a program-counted FLOP count) over one
    throughput measurement, both divided across ``n_chips``. In the port
    the second count is the first (see the module docstring).
    ``peak_tflops`` defaults to the card's (``detect_chip("cuda")``)."""
    if peak_tflops is None:
        from jumbo_mae_tpu_tpu_torch.obs.perfmodel import detect_chip

        peak_tflops = detect_chip("cuda").peak_tflops
    peak = max(float(peak_tflops), 1e-12)
    model_t = analytic_flops_per_step / max(n_chips, 1) * steps_per_sec / 1e12
    hw_t = (xla_flops_per_step or 0.0) / max(n_chips, 1) * steps_per_sec / 1e12
    return UtilizationReport(
        model_flops_utilization=model_t / peak,
        hardware_flops_utilization=hw_t / peak,
        achieved_model_tflops=model_t,
        achieved_hardware_tflops=hw_t,
        peak_tflops=peak,
    )
