"""The port's autoscaler (``serve/autoscaler.py``) against the JAX
package's, on the CPU: a scripted fake pool (``stats()``, ``scale_to``)
and a fake SLO drive both with ``tick(now)``, and the decision dicts, the
``scale_to`` calls, the journaled ``autoscale`` events and the gauges are
equal — up on demand, down one step after the hold, the burn and breaker
steps, the bounds (the cases of ``tests/test_serve.py``'s autoscaler
tests, on seeded traffic). ``roofline_capacity`` equals JAX's on the same
chip fields, and without a chip it needs the card."""

import numpy as np
import pytest
import torch

from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu.obs.perfmodel import ChipSpec as JaxChip
from jumbo_mae_tpu_tpu.serve.autoscaler import Autoscaler as JaxAutoscaler
from jumbo_mae_tpu_tpu.serve.autoscaler import roofline_capacity as jax_roofline_capacity
from jumbo_mae_tpu_tpu_torch.models.config import preset
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.obs.mfu import encoder_flops_per_image
from jumbo_mae_tpu_tpu_torch.obs.perfmodel import H100, ChipSpec
from jumbo_mae_tpu_tpu_torch.serve import Autoscaler, roofline_capacity


class FakePool:
    """``stats()`` and ``scale_to`` of a replica pool, scripted."""

    def __init__(self, n=2):
        self.n = n
        self.submitted = 0
        self.served = 0
        self.queue_depth = 0
        self.breaker = False
        self.calls = []

    def stats(self):
        return {
            "requests_submitted": self.submitted,
            "queue_depth": self.queue_depth,
            "breaker_open": self.breaker,
            "healthy": self.n,
            "batch_occupancy": 0.5,
            "replicas": {f"r{i}": {"served": self.served // self.n} for i in range(self.n)},
        }

    def scale_to(self, target, *, drain_timeout_s=10.0):
        report = {"from": self.n, "to": target}
        self.calls.append(target)
        self.n = target
        return report


class SLO:
    def __init__(self):
        self.burn = 0.0

    def worst_burn(self, now=None):
        return self.burn


class Events:
    def __init__(self):
        self.rows = []

    def event(self, etype, **fields):
        self.rows.append((etype, fields))


def pair(n=2, **kw):
    """Both autoscalers, each over its own fake pool, SLO and event log."""
    out = []
    for cls, reg in ((Autoscaler, MetricsRegistry()), (JaxAutoscaler, JaxRegistry())):
        pool, slo, events = FakePool(n), SLO(), Events()
        asc = cls(pool, slo=slo, tracer=events, registry=reg, start=False, clock=lambda: 0.0, **kw)
        out.append((asc, pool, slo, events, reg))
    return out


def step(sides, now, **state):
    decisions = []
    for asc, pool, slo, _, _ in sides:
        for k, v in state.items():
            if k == "burn":
                slo.burn = v
            else:
                setattr(pool, k, v)
        decisions.append(asc.tick(now=now))
    assert decisions[0] == decisions[1]
    return decisions[0]


def same_sides(sides):
    (pa, pp, _, pe, preg), (ja, jp, _, je, jreg) = sides
    assert pp.calls == jp.calls and pp.n == jp.n
    assert pa.events == ja.events and pe.rows == je.rows
    for fam in ("serve_autoscale_target", "serve_autoscale_demand", "serve_autoscale_capacity",
                "serve_autoscale_events_total"):
        assert preg.snapshot()[fam] == jreg.snapshot()[fam], fam


def test_scales_up_on_demand_down_after_hold():
    sides = pair(n=2, min_replicas=2, max_replicas=4, interval_s=1.0, capacity_fn=lambda: 100.0, down_hold=3)
    step(sides, 0.0)
    d = step(sides, 1.0, submitted=300, queue_depth=150)
    assert d["target"] > 2 and d["reason"] == "demand" and sides[0][1].calls == [d["target"]]
    start = sides[0][1].n
    for t in (2.0, 3.0):
        step(sides, t, queue_depth=0)
    assert sides[0][1].n == start  # held
    step(sides, 4.0, queue_depth=0)
    assert sides[0][1].n == start - 1  # one step
    same_sides(sides)


def test_burn_and_breaker_force_a_step_up():
    sides = pair(n=2, min_replicas=1, max_replicas=4, capacity_fn=lambda: 1000.0)
    d = step(sides, 0.0, burn=5.0)
    assert d["reason"] == "burn" and sides[0][1].n == 3
    same_sides(sides)
    sides = pair(n=2, min_replicas=1, max_replicas=4, capacity_fn=lambda: 1000.0)
    d = step(sides, 0.0, breaker=True)
    assert d["reason"] == "breaker" and sides[0][1].n == 3
    same_sides(sides)


def test_bounds_and_validation():
    with pytest.raises(ValueError):
        Autoscaler(FakePool(), min_replicas=3, max_replicas=2, start=False, registry=MetricsRegistry())
    sides = pair(n=4, min_replicas=2, max_replicas=4, capacity_fn=lambda: 1.0, down_hold=1)
    step(sides, 0.0)
    d = step(sides, 1.0, submitted=10_000)
    assert d["target"] == 4
    same_sides(sides)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_traffic_equals_jax(seed):
    """Bursts, lulls, burn spikes and breaker flaps with the live
    capacity estimate (no model for seeds 0 and 2)."""
    cap = None if seed % 2 == 0 else (lambda: 40.0)
    sides = pair(n=1, min_replicas=1, max_replicas=5, interval_s=0.5, capacity_fn=cap, down_hold=2)
    rng = np.random.default_rng(seed)
    t, submitted, served = 0.0, 0, 0
    for _ in range(120):
        t += float(rng.choice([0.25, 0.5, 1.0]))
        submitted += int(rng.choice([0, 5, 40, 400]))
        served = min(submitted, served + int(rng.integers(0, 200)))
        step(sides, t, submitted=submitted, served=served, queue_depth=submitted - served,
             burn=float(rng.choice([0.0, 0.0, 0.5, 3.0])), breaker=bool(rng.random() < 0.05))
    same_sides(sides)
    assert sides[0][0].events  # the pool moved


def test_roofline_capacity_equals_jax():
    rows = [("h100", H100.peak_tflops, H100.hbm_gbps, H100.ici_gbps, 8e10), ("slow", 10.0, 100.0, 5.0, 0.0)]
    for row in rows:
        for flops, nbytes, util in ((3.6e10, 1.5e8, 0.5), (1e9, 1e7, 1.0), (1e6, 1e12, 0.25)):
            got = roofline_capacity(flops, nbytes, ChipSpec(*row), utilization=util)
            assert got == jax_roofline_capacity(flops, nbytes, JaxChip(*row), utilization=util) > 0
    # ViT-B/16 at 224 px: ~36 GFLOP an image, ~13,700 images/s a replica at half the H100's roofline
    flops = encoder_flops_per_image(preset("vit_b16", mask_ratio=None), masked=False)
    vit_b = roofline_capacity(flops, 2.0 * flops / 768, H100)
    assert 35e9 < flops < 37e9 and 13_000 < vit_b < 14_500
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline_capacity(1e9, 1e7)
