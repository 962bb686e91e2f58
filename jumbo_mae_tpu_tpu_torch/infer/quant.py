"""Int8 weight-only post-training quantization for the serving forward.

Counterpart of ``jumbo_mae_tpu_tpu/infer/quant.py``, with its rule:

- **What quantizes.** Matmul weights with ndim >= 2 — the leaves the flax
  tree names ``kernel`` (:func:`~jumbo_mae_tpu_tpu_torch.interop.from_jax.flax_path`
  of a ``nn.Linear`` or ``nn.Conv2d`` weight): the patch embedding conv,
  q/k/v/out, the MLPs, the head and the decoder stack. Positional
  embeddings, CLS and mask tokens, norms, LayerScale, biases and
  BatchNorm statistics stay float32.
- **How.** Symmetric per-output-channel scales, ``scale = max|w| / 127``
  over the axes the matmul contracts away (a zero channel gets scale 1),
  ``q = clip(round(w / scale), -127, 127)`` as int8. The flax layouts put
  the output last (q/k/v: the trailing (heads, head_dim) pair); the
  port's weights put it first, so every weight reduces over all axes but
  axis 0 (:func:`_reduction_axes`) and ``q`` and ``scale`` are the JAX
  ones, laid out as the port lays out the weight.
- **Dequant on use.** :func:`quantize_module` replaces each such weight
  by two buffers of its module, the int8 ``weight_q`` and the float32
  ``weight_scale``; the module's ``weight`` becomes ``q.float() * scale``,
  computed inside its forward and cast there to the compute dtype. The
  card holds int8. The product is exact per weight, so the quantized
  forward is as deterministic and as row-independent as the float32 one
  (padding stays inert). The JAX package gets the same by passing the
  int8 tree into its jitted forward, where XLA fuses the dequantization;
  here it is plain torch ops, one float32 view per weight per dispatch.

Parity is measured, never assumed: :func:`parity_report` runs the same
images through a reference and a quantized engine and holds feature
cosine and logits top-1 agreement to the tolerances below.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from jumbo_mae_tpu_tpu_torch.interop.from_jax import flax_path

# the JAX package's stated parity tolerances
FEATURE_COSINE_MIN = 0.999
TOP1_AGREEMENT_MIN = 0.98


@dataclass
class QuantizedTensor:
    """An int8 weight and its per-output-channel float32 scale; ``scale``
    keeps the reduced axes as size-1 dims, so ``q * scale`` broadcasts."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``q * scale`` in float32, then cast to ``dtype``."""
        return (self.q.float() * self.scale).to(dtype)


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


def _reduction_axes(ndim: int) -> tuple[int, ...]:
    """The axes a matmul contracts away: all but the output channels,
    which are axis 0 of a ``nn.Linear`` (out, in) or ``nn.Conv2d`` (O, I,
    H, W) weight. The JAX rule on flax layouts (q/k/v (D, H, hd) keep
    (H, hd); every other kernel keeps its last axis) is this rule on the
    port's."""
    return tuple(range(1, ndim))


def quantize_tensor(w: torch.Tensor, axes: tuple[int, ...]) -> QuantizedTensor:
    """Symmetric int8 quantization of one weight over ``axes``."""
    w = w.detach().float()
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def _quantizes(name: str, t: torch.Tensor) -> bool:
    return flax_path(name)[-1] == "kernel" and t.dim() >= 2


def quantize_params(params: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """Quantize a params dict (``state_dict`` names); returns
    ``(quantized, report)``: matmul weights become :class:`QuantizedTensor`
    entries, the rest passes through. ``report`` counts leaves and bytes
    before and after and gives the compression ratio."""
    report = {"n_quantized": 0, "n_kept": 0, "bytes_before": 0, "bytes_after": 0}
    out: dict = {}
    for name, t in params.items():
        if is_quantized(t):
            raise ValueError(
                f"{name} is already quantized — quantize_params expects a float32 params dict, not its own output"
            )
        nbytes = t.numel() * t.element_size()
        report["bytes_before"] += nbytes
        if _quantizes(name, t):
            qt = quantize_tensor(t, _reduction_axes(t.dim()))
            report["n_quantized"] += 1
            report["bytes_after"] += qt.q.numel() + qt.scale.numel() * qt.scale.element_size()
            out[name] = qt
        else:
            report["n_kept"] += 1
            report["bytes_after"] += nbytes
            out[name] = t
    report["compression"] = round(report["bytes_before"] / max(report["bytes_after"], 1), 3)
    return out, report


def dequantize_tree(tree: dict, dtype: torch.dtype = torch.float32) -> dict:
    """Every :class:`QuantizedTensor` entry of ``tree`` dequantized."""
    return {n: v.dequantize(dtype) if is_quantized(v) else v for n, v in tree.items()}


class _Int8Weight:
    """Mixin of a module whose ``weight`` is the int8 buffers' product."""

    @property
    def weight(self) -> torch.Tensor:
        return self.weight_q.float() * self.weight_scale


_INT8_CLASSES: dict[type, type] = {}


def _int8_class(cls: type) -> type:
    if cls not in _INT8_CLASSES:
        _INT8_CLASSES[cls] = type(f"Int8{cls.__name__}", (_Int8Weight, cls), {})
    return _INT8_CLASSES[cls]


@torch.no_grad()
def quantize_module(model: nn.Module) -> dict:
    """Quantize ``model``'s matmul weights in place (:func:`quantize_params`
    over its parameters): each module's ``weight`` parameter becomes the
    buffers ``weight_q`` (int8) and ``weight_scale`` (float32) on the same
    device, and its ``weight`` is dequantized on every use. Returns the
    report, plus ``int8_bytes``: the bytes of the quantized weights as the
    card holds them."""
    qtree, report = quantize_params(dict(model.named_parameters()))
    report["int8_bytes"] = 0
    for name, v in qtree.items():
        if not is_quantized(v):
            continue
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        if attr != "weight" or not isinstance(mod, (nn.Linear, nn.Conv2d)):
            raise TypeError(f"{name}: only nn.Linear and nn.Conv2d weights quantize, got {type(mod).__name__}")
        del mod._parameters["weight"]
        mod.register_buffer("weight_q", v.q)
        mod.register_buffer("weight_scale", v.scale)
        mod.__class__ = _int8_class(type(mod))
        report["int8_bytes"] += v.q.numel() + v.scale.numel() * v.scale.element_size()
    return report


def int8_layout(model: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Give ``model`` the layout :func:`quantize_module` leaves, for a
    ``state`` dict saved from a quantized model (the warm cache's entries):
    each module with a ``<module>.weight_q`` entry loses its ``weight``
    parameter for empty ``weight_q``/``weight_scale`` buffers of the
    entry's shapes and dtypes on the model's device, to be filled from
    ``state``. Nothing is quantized here."""
    for name, q in state.items():
        if not name.endswith(".weight_q"):
            continue
        mod_name = name[: -len(".weight_q")]
        mod = model.get_submodule(mod_name)
        if not isinstance(mod, (nn.Linear, nn.Conv2d)) or "weight" not in mod._parameters:
            raise TypeError(f"{name}: no nn.Linear or nn.Conv2d weight to lay out as int8")
        scale = state[f"{mod_name}.weight_scale"]
        dev = mod._parameters["weight"].device
        del mod._parameters["weight"]
        mod.register_buffer("weight_q", torch.empty(q.shape, dtype=q.dtype, device=dev))
        mod.register_buffer("weight_scale", torch.empty(scale.shape, dtype=scale.dtype, device=dev))
        mod.__class__ = _int8_class(type(mod))


# ------------------------------------------------------------------ parity


def feature_cosine(a, b) -> np.ndarray:
    """Per-row cosine similarity between two feature matrices."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    num = (a * b).sum(axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return num / np.maximum(den, 1e-12)


def top1_agreement(logits_a, logits_b) -> float:
    a = np.asarray(logits_a)
    b = np.asarray(logits_b)
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def parity_report(reference, quantized, images, *, task: str = "features", pool: str = "cls",
                  registry=None) -> dict:
    """The same images through a reference and a quantized engine.
    ``features``: per-image cosine (min and mean) against
    :data:`FEATURE_COSINE_MIN`; ``logits``: top-1 agreement against
    :data:`TOP1_AGREEMENT_MIN` and the largest logit difference. The
    verdict is ``within_tolerance``, also published in the
    ``infer_quant_parity{metric}`` gauges of ``registry`` (default: the
    process registry)."""
    if task not in ("features", "logits"):
        raise ValueError(f"parity is defined for features/logits, got {task!r}")
    rep: dict = {"task": task, "images": int(np.asarray(images).shape[0])}
    if task == "features":
        cos = feature_cosine(reference.features(images, pool=pool), quantized.features(images, pool=pool))
        rep.update(
            cosine_min=round(float(cos.min()), 6),
            cosine_mean=round(float(cos.mean()), 6),
            tolerance={"cosine_min": FEATURE_COSINE_MIN},
        )
        rep["within_tolerance"] = rep["cosine_min"] >= FEATURE_COSINE_MIN
    else:
        ref = reference.logits(images)
        q = quantized.logits(images)
        rep.update(
            top1_agreement=round(top1_agreement(ref, q), 6),
            max_abs_logit_delta=round(float(np.abs(ref - q).max()), 6),
            tolerance={"top1_agreement": TOP1_AGREEMENT_MIN},
        )
        rep["within_tolerance"] = rep["top1_agreement"] >= TOP1_AGREEMENT_MIN
    if registry is None:
        from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

        registry = get_registry()
    gauge = registry.gauge("infer_quant_parity", "quantized-vs-reference parity measurements", labels=("metric",))
    for name in ("cosine_min", "cosine_mean", "top1_agreement"):
        if name in rep:
            gauge.labels(name).set(rep[name])
    gauge.labels("within_tolerance").set(1.0 if rep["within_tolerance"] else 0.0)
    return rep
