"""The port's tenant cost meter (``serve/costmeter.py``) and budgeted
admission (``serve/admission.py``) against the JAX package's, on the CPU:

- the same trace stream (image-bucketed batches, token-packed groups and
  padded buckets, tenants with and without budgets, an unknown tenant),
  the same injected clock and the same ``cost_fn`` give equal stamps on
  every trace, equal ``snapshot()``, ``window_usage``, ``over_budget`` and
  equal ``tenant_usage`` journal rows (timestamps aside), exactly;
- the conservation law: Σ tenant device_s = Σ run_s and Σ flops =
  exec_flops × batches, to 1e-12;
- ``AdmissionController(meter=...)`` makes the same accept or shed
  decisions, with the same reasons and the same
  ``serve_tenant_budget_remaining``, as JAX's over a scripted sequence of
  pressure, usage and time.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from jumbo_mae_tpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from jumbo_mae_tpu_tpu.obs.perfmodel import ChipSpec as JaxChip
from jumbo_mae_tpu_tpu.serve.admission import AdmissionController as JaxAdmission
from jumbo_mae_tpu_tpu.serve.admission import parse_tenants as jax_parse_tenants
from jumbo_mae_tpu_tpu.serve.costmeter import CostMeter as JaxMeter
from jumbo_mae_tpu_tpu_torch.obs.metrics import MetricsRegistry
from jumbo_mae_tpu_tpu_torch.obs.perfmodel import H100, ChipSpec
from jumbo_mae_tpu_tpu_torch.serve import AdmissionController, CostMeter, TenantBudgetError, parse_tenants

SPEC = "web=interactive:rate=50,scrape=batch:budget=0.05:window=2,bulk=scavenger:budget=0.2,probe=batch"


class Clock:
    def __init__(self):
        self.t = 500.0

    def __call__(self):
        return self.t


class Events:
    """A tracer stand-in that records journal events."""

    def __init__(self):
        self.rows = []

    def event(self, etype, **fields):
        self.rows.append((etype, fields))


def cost_fn(engine, task, bucket):
    """A per-(task, bucket) cost table: dicts, as the batch CLI's stub
    gives, with a hole (``probe``) that bills device time only."""
    if task == "probe":
        return None
    per = {"features": 2.0e9, "logits": 2.1e9, "packed": 0.05e9}[task]
    return {"flops": per * bucket, "bytes_accessed": 1e6 + 3e5 * bucket}


def stream(seed: int):
    """Batches of ``(run_s, dt, [trace fields])``: image buckets with pad,
    packed groups with per-trace tokens, a padded bucket of one."""
    rng = np.random.default_rng(seed)
    tenants = [("web", "interactive"), ("scrape", "batch"), ("bulk", "scavenger"), ("probe", "batch"),
               ("stranger", None)]
    out = []
    for b in range(40):
        kind = b % 4
        n = int(rng.integers(1, 9))
        fields = []
        for _ in range(n):
            t, c = tenants[int(rng.integers(len(tenants)))]
            f = {"tenant": t, "tclass": c, "task": ["features", "logits", "packed", "probe"][kind]}
            if kind == 0:  # image bucket: the next power of two, its pad
                bucket = 1 << (n - 1).bit_length()
                f.update(bucket=bucket, pad_fraction=(bucket - n) / bucket)
            elif kind == 1:  # bucket of its own size, no pad recorded
                f.update(bucket=n)
            elif kind == 2:  # token-packed: per-trace tokens, the budget as bucket
                f.update(bucket=1024, pad_fraction=float(rng.uniform(0, 0.4)), tokens=int(rng.choice([52, 103, 199])))
            else:  # no breakdown at all
                pass
            fields.append(f)
        out.append((float(rng.uniform(0.001, 0.03)), float(rng.choice([0.05, 0.3, 1.5])), fields))
    return out


def trace(f: dict) -> SimpleNamespace:
    base = {"tenant": None, "tclass": None, "task": None, "bucket": None, "pad_fraction": None, "tokens": None,
            "device_s": None, "cost_flops": None}
    return SimpleNamespace(**{**base, **f})


def meters(clock, events_p, events_j, **kw):
    chip = ("h100", H100.peak_tflops, H100.hbm_gbps, H100.ici_gbps, 8e10)
    port = CostMeter(parse_tenants(SPEC), cost_fn=cost_fn, chip=ChipSpec(*chip), tracer=events_p,
                     registry=MetricsRegistry(), clock=clock, **kw)
    ref = JaxMeter(jax_parse_tenants(SPEC), cost_fn=cost_fn, chip=JaxChip(*chip), tracer=events_j,
                   registry=JaxRegistry(), clock=clock, **kw)
    return port, ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_meter_equals_jax_over_a_stream(seed):
    clock, ep, ej = Clock(), Events(), Events()
    port, ref = meters(clock, ep, ej, window_s=4.0, journal_interval_s=1.0)
    run_total, flops_total = 0.0, 0.0
    for run_s, dt, fields in stream(seed):
        clock.t += dt
        pt, jt = [trace(f) for f in fields], [trace(f) for f in fields]
        port.observe_batch(run_s=run_s, traces=pt, batch=len(pt), engine=None)
        ref.observe_batch(run_s=run_s, traces=jt, batch=len(jt), engine=None)
        assert [(t.device_s, t.cost_flops) for t in pt] == [(t.device_s, t.cost_flops) for t in jt]
        run_total += run_s
        cost = cost_fn(None, fields[0]["task"], fields[0].get("bucket") or len(fields))
        flops_total += cost["flops"] if cost else 0.0
        for tenant in ("web", "scrape", "bulk", "probe", "stranger", "nobody"):
            assert port.window_usage(tenant) == ref.window_usage(tenant)
            assert port.window_usage(tenant, 2.0) == ref.window_usage(tenant, 2.0)
            assert port.over_budget(tenant) == ref.over_budget(tenant)
            assert port.budget_for(tenant) == ref.budget_for(tenant)
        assert port.snapshot() == ref.snapshot()
    port.flush()
    ref.flush()
    usage = [r for r in ep.rows if r[0] == "tenant_usage"]
    assert usage == [r for r in ej.rows if r[0] == "tenant_usage"] and len(usage) > 5
    snap = port.snapshot()
    # the conservation law
    assert abs(sum(t["device_s"] for t in snap["tenants"].values()) - run_total) <= 1e-12 * run_total
    assert abs(snap["total_device_s"] - run_total) <= 1e-12 * run_total
    assert abs(sum(t["flops"] for t in snap["tenants"].values()) - flops_total) <= 1e-12 * flops_total
    assert snap["total_batches"] == 40 and snap["chip"] == "h100" and 0 < snap["roofline_utilization"]


def test_conservation_over_uniform_batches():
    """Σ flops = exec_flops × batches when every batch runs one program."""
    clock = Clock()
    meter = CostMeter(parse_tenants(SPEC), cost_fn=lambda e, t, b: {"flops": 3.3e10}, registry=MetricsRegistry(),
                      clock=clock)
    rng = np.random.default_rng(5)
    runs = []
    for _ in range(25):
        n = int(rng.integers(1, 7))
        runs.append(float(rng.uniform(0.001, 0.02)))
        meter.observe_batch(run_s=runs[-1], traces=[trace({"tenant": ["web", "scrape", "bulk"][i % 3], "bucket": 8,
                                                            "task": "features"}) for i in range(n)], batch=n)
        clock.t += 0.1
    snap = meter.snapshot()
    assert abs(sum(t["flops"] for t in snap["tenants"].values()) - 3.3e10 * 25) <= 1e-12 * 3.3e10 * 25
    assert abs(sum(t["device_s"] for t in snap["tenants"].values()) - sum(runs)) <= 1e-12 * sum(runs)
    assert "chip" not in snap and "roofline_utilization" not in snap  # no chip named, none guessed


def test_admission_with_a_meter_equals_jax():
    """A scripted sequence of (time, pressure, tenant, billed usage): the
    same admits and typed sheds, the same stats and budget gauges."""
    clock = Clock()
    port_meter, ref_meter = meters(clock, None, None, window_s=4.0)
    preg, jreg = MetricsRegistry(), JaxRegistry()
    pressure = {"p": 0.0}
    spec = SPEC.replace("rate=50", "rate=0.5:burst=1")
    port = AdmissionController(parse_tenants(spec), pressure_fn=lambda: pressure["p"], meter=port_meter,
                               registry=preg, clock=clock)
    ref = JaxAdmission(jax_parse_tenants(spec), pressure_fn=lambda: pressure["p"], meter=ref_meter, registry=jreg,
                       clock=clock)
    rng = np.random.default_rng(11)
    outcomes = {"port": [], "jax": []}
    for _ in range(400):
        clock.t += float(rng.choice([0.001, 0.01, 0.01, 0.05, 0.9]))
        pressure["p"] = float(rng.choice([0.0, 0.0, 0.3, 0.55, 0.9, 1.0]))
        tenant = ["web", "scrape", "bulk", "probe", None, "stranger"][int(rng.integers(6))]
        for name, ctl in (("port", port), ("jax", ref)):
            try:
                outcomes[name].append(("ok", ctl.admit(tenant).tclass))
            except Exception as e:  # noqa: BLE001 - typed sheds are the outcome
                outcomes[name].append((type(e).__name__, None))
        if rng.random() < 0.5:  # bill the tenant's next batch through both meters
            run_s = float(rng.uniform(0.005, 0.03))
            for m in (port_meter, ref_meter):
                m.observe_batch(run_s=run_s, traces=[trace({"tenant": tenant or "_default", "task": "features",
                                                             "bucket": 4})], batch=1)
    assert outcomes["port"] == outcomes["jax"]
    kinds = {o[0] for o in outcomes["port"]}
    assert {"ok", "TenantBudgetError", "TenantPressureError", "TenantQuotaError"} <= kinds
    assert port.stats() == ref.stats()
    for fam in ("serve_tenant_budget_remaining", "serve_admit_shed_total", "serve_admit_total"):
        assert preg.snapshot()[fam] == jreg.snapshot()[fam], fam


def test_over_budget_tenant_is_admitted_at_zero_pressure():
    clock = Clock()
    meter = CostMeter(parse_tenants("scrape=batch:budget=0.01:window=2"), cost_fn=None, registry=MetricsRegistry(),
                      clock=clock)
    adm = AdmissionController(parse_tenants("scrape=batch:budget=0.01:window=2"), meter=meter,
                              registry=(reg := MetricsRegistry()), clock=clock)
    meter.observe_batch(run_s=0.05, traces=[trace({"tenant": "scrape", "task": "features"})], batch=1)
    assert adm.admit("scrape").name == "scrape"  # a budget bounds contention, it is no kill switch
    assert reg.snapshot()["serve_tenant_budget_remaining"]["scrape,batch"] == 0.0
    adm.set_pressure_fn(lambda: 0.6)
    with pytest.raises(TenantBudgetError):
        adm.admit("scrape")
    clock.t += 2.5  # the window rolls
    assert adm.admit("scrape").name == "scrape"
    assert reg.snapshot()["serve_tenant_budget_remaining"]["scrape,batch"] == 0.01
