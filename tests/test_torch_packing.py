"""The port's token-packing planner (``infer/packing.py``) against the JAX
package's, on the CPU.

The planner is numpy and deterministic, so the comparison is exact: the
same length lists (hypothesis-drawn, and the serving mix of 224, 160 and
96 px ViT-B/16 requests) give equal plans, equal plan arrays and equal
placed buffers in both packages.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from jumbo_mae_tpu_tpu.infer import bucketing as jbucketing
from jumbo_mae_tpu_tpu.infer import packing as jpacking
from jumbo_mae_tpu_tpu_torch.infer import bucketing, packing

LENGTHS = st.lists(st.integers(1, 300), min_size=1, max_size=24)


def _same_plan(a, b) -> None:
    assert (a.budget, a.rows, a.max_segments) == (b.budget, b.rows, b.max_segments)
    assert [tuple(vars(s).values()) for s in a.segments] == [tuple(vars(s).values()) for s in b.segments]


@settings(max_examples=60, deadline=None, database=None)
@given(lengths=LENGTHS, budget=st.sampled_from([300, 512, 1024]))
def test_pack_ffd_equals_jax(lengths, budget):
    _same_plan(packing.pack_ffd(lengths, budget), jpacking.pack_ffd(lengths, budget))


@settings(max_examples=60, deadline=None, database=None)
@given(lengths=LENGTHS, max_tokens=st.sampled_from([300, 1024, 4096]))
def test_choose_budget_equals_jax(lengths, max_tokens):
    rungs = packing.budget_rungs(max_tokens)
    assert rungs == jpacking.budget_rungs(max_tokens)
    b, plan = packing.choose_budget(lengths, rungs)
    jb, jplan = jpacking.choose_budget(lengths, rungs)
    assert b == jb
    _same_plan(plan, jplan)
    assert plan.pad_fraction() == jplan.pad_fraction()


@settings(max_examples=40, deadline=None, database=None)
@given(lengths=st.lists(st.integers(4, 120), min_size=1, max_size=12), k=st.sampled_from([1, 3]),
       seed=st.integers(0, 2**16))
def test_build_arrays_and_place_tokens_equal_jax(lengths, k, seed):
    lengths = [max(n, k + 1) for n in lengths]
    rungs = packing.budget_rungs(512)
    _, plan = packing.choose_budget(lengths, rungs)
    _, jplan = jpacking.choose_budget(lengths, rungs)
    rows, smax = bucketing.ceil_pow2(plan.rows), bucketing.ceil_pow2(plan.max_segments)
    assert (rows, smax) == (jbucketing.ceil_pow2(jplan.rows), jbucketing.ceil_pow2(jplan.max_segments))
    got = packing.build_arrays(plan, k, rows=rows, max_segments=smax)
    want = jpacking.build_arrays(jplan, k, rows=rows, max_segments=smax)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].dtype == want[name].dtype
    rng = np.random.default_rng(seed)
    toks = [rng.standard_normal((n - k, 8)).astype(np.float32) for n in lengths]
    buf = packing.place_tokens(plan, toks, k, rows=rows)
    np.testing.assert_array_equal(buf, jpacking.place_tokens(jplan, toks, k, rows=rows))
    out = rng.standard_normal((rows, smax, 5))
    for a, b in zip(packing.unpack_rows(plan, out), jpacking.unpack_rows(jplan, out)):
        np.testing.assert_array_equal(a, b)


def test_serving_mix_one_rung():
    """ViT-B/16's 224, 160 and 96 px requests (199, 103 and 39 tokens with
    3 CLS) land in one 4096-token rung, as in the JAX package."""
    lengths = [3 + (s // 16) ** 2 for s in (224, 160, 96)]
    assert lengths == [199, 103, 39]
    mix = lengths * 8
    b, plan = packing.choose_budget(mix, packing.budget_rungs(4096))
    jb, jplan = jpacking.choose_budget(mix, jpacking.budget_rungs(4096))
    assert b == jb
    _same_plan(plan, jplan)


@pytest.mark.parametrize("k,m", [(0, 8), (1, 8), (5, 8), (8, 8), (9, 8), (3, 1), (64, 64), (70, 64)])
def test_floor_bucket_and_ceil_pow2_equal_jax(k, m):
    assert bucketing.floor_bucket(k, m) == jbucketing.floor_bucket(k, m)
    if k:
        assert bucketing.ceil_pow2(k) == jbucketing.ceil_pow2(k)


def test_planning_errors_match():
    for call in (lambda p: p.pack_ffd([10], 0), lambda p: p.pack_ffd([0], 64), lambda p: p.pack_ffd([65], 64),
                 lambda p: p.choose_budget([5000], p.budget_rungs(4096))):
        with pytest.raises(ValueError):
            call(packing)
        with pytest.raises(ValueError):
            call(jpacking)
    plan = packing.pack_ffd([10, 20], 32)
    with pytest.raises(ValueError, match="plan needs"):
        packing.build_arrays(plan, 1, rows=0)
    with pytest.raises(ValueError, match="planned"):
        packing.place_tokens(plan, [np.zeros((3, 2)), np.zeros((19, 2))], 1)
