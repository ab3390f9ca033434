"""The traffic generator: deterministic per seed, the stated distributions,
the same work for every seed, and every law found by its name."""

import json
import math
import statistics

import numpy as np
import pytest

from kbench import traffic

POISSON = traffic.load("random-1k-poisson")
BACKLOG = traffic.load("random-1k-backlog")
LOGNORMAL = {"law": "lognormal", "median": 384, "sigma": 0.6, "min": 32, "max": 2048}


def _mix(**kw):
    return dict(POISSON, **kw)


def test_same_seed_same_requests_other_seed_other_tokens():
    a = traffic.plan(POISSON, 2**31 + 7, 32000, rate=3.0)
    b = traffic.plan(POISSON, 2**31 + 7, 32000, rate=3.0)
    c = traffic.plan(POISSON, 11, 32000, rate=3.0)
    assert a.due == b.due and a.request(5) == b.request(5)
    # every seed sends the same schedule of sizes and arrivals ...
    assert a.due == c.due and a.prompt_lens == c.prompt_lens
    assert a.output_lens == c.output_lens
    # ... of other tokens
    assert a.request(5)[0] != c.request(5)[0] and len(a.request(5)[0]) == len(c.request(5)[0])
    # the schedule is the law's in the mix's own order
    m = _mix(prompt=LOGNORMAL)
    d = traffic.plan(m, 11, 32000, rate=3.0)
    e = traffic.plan(dict(m, schedule_seed=m["schedule_seed"] + 1), 11, 32000, rate=3.0)
    assert e.prompt_lens != d.prompt_lens and sorted(e.prompt_lens) == sorted(d.prompt_lens)


def test_the_schedule_does_not_depend_on_the_rate_or_the_window():
    """One draw of a fixed number of arrivals: another rate scales the due
    times, and a longer window only reaches further into the same list."""
    a = traffic.plan(POISSON, 5, 32000, rate=2.0)
    b = traffic.plan(POISSON, 5, 32000, rate=4.0)
    assert len(a.due) == len(b.due) == traffic.ARRIVALS
    assert a.due == pytest.approx([2.0 * t for t in b.due])


def test_the_mixes_are_vllm_s_random_set():
    for mix in (POISSON, BACKLOG):
        assert "benchmark_serving" in mix["source"]
        assert mix["prompt"] == {"law": "fixed", "tokens": 1024}
        assert mix["output"] == {"law": "fixed", "tokens": 128}
    p = traffic.plan(BACKLOG, 3, 32000)
    assert not p.open and p.due == [] and p.target(64) == 128
    assert set(p.prompt_lens) == {1024} and set(p.output_lens) == {128}


@pytest.mark.parametrize("sigma", [0.6, 1.0])
def test_lognormal_lengths_match_their_parameters(sigma):
    spec = dict(LOGNORMAL, sigma=sigma, min=1, max=10**6)
    v = traffic.lengths(spec, traffic.POOL, np.random.default_rng(0))
    assert min(v) >= spec["min"] and max(v) <= spec["max"]
    assert abs(statistics.median(v) - spec["median"]) <= 1
    # the log-lengths' spread is sigma
    logs = sorted(math.log(x) for x in v)
    q1, q3 = logs[len(logs) // 4], logs[3 * len(logs) // 4]
    assert (q3 - q1) / 1.349 == pytest.approx(spec["sigma"], rel=0.05)
    clipped = traffic.lengths(LOGNORMAL, traffic.POOL, None)
    assert min(clipped) >= 32 and max(clipped) <= 2048


def test_uniform_lengths_cover_their_range():
    v = traffic.lengths({"law": "uniform", "min": 4096, "max": 8192}, traffic.POOL, None)
    assert min(v) == 4096 + 2 and max(v) == 8192 - 2
    assert statistics.mean(v) == pytest.approx((4096 + 8192) / 2, abs=1)


def test_a_mixture_gives_each_part_its_share():
    spec = {"law": "mixture", "parts": [
        dict(law="fixed", tokens=64, weight=3),
        dict(law="uniform", min=4000, max=6000, weight=1)]}
    v = traffic.lengths(spec, 1000, np.random.default_rng(0))
    assert len(v) == 1000 and v.count(64) == 750
    assert all(4000 <= x <= 6000 for x in v if x != 64)


def test_poisson_arrivals_keep_their_rate():
    p = traffic.plan(POISSON, 3, 32000, rate=2.5)
    gaps = np.diff([0.0] + p.due)
    assert gaps.mean() == pytest.approx(1 / 2.5, rel=0.01)
    # exponential: the spread of the gaps equals their mean
    assert gaps.std() == pytest.approx(1 / 2.5, rel=0.05)
    # and so does that of the first two hundred, which a window sends
    assert gaps[:200].mean() == pytest.approx(1 / 2.5, rel=0.2)


def test_gamma_arrivals_keep_their_rate_and_burst():
    p = traffic.plan(_mix(arrivals={"law": "gamma", "cv": 2.0}), 3, 32000, rate=2.0)
    gaps = np.diff([0.0] + p.due)
    assert gaps.mean() == pytest.approx(0.5, rel=1e-6)
    assert gaps.std() / gaps.mean() == pytest.approx(2.0, rel=0.1)


def test_prompts_are_distinct_tokens_in_the_vocabulary():
    p = traffic.plan(BACKLOG, 5, 32000)
    r0, r1 = p.request(0)[0], p.request(1)[0]
    assert all(0 <= t < 32000 for t in r0 + r1)
    assert r0[:64] != r1[:64]
    assert len(r0) == p.prompt_lens[0] and p.request(0)[1] == p.output_lens[0]


def test_a_shared_prefix_comes_before_every_prompt():
    mix = dict(BACKLOG, tokens={"law": "shared_prefix", "prefix_tokens": 200})
    p, q = traffic.plan(mix, 5, 32000), traffic.plan(mix, 6, 32000)
    r0, r1 = p.request(0)[0], p.request(1)[0]
    assert len(r0) == 200 + 1024 and r0[:200] == r1[:200] and r0[200:264] != r1[200:264]
    assert q.request(0)[0][:200] != r0[:200]  # the seed draws the prefix


@pytest.mark.parametrize("kind,key", [("arrivals", "arrivals"), ("lengths", "prompt"),
                                      ("prompts", "tokens")])
def test_an_unknown_law_is_an_error(kind, key):
    with pytest.raises(ValueError, match="unknown"):
        traffic.plan(dict(POISSON, **{key: {"law": "no_such_law"}}), 1, 100, rate=1.0)


@pytest.mark.parametrize("path", sorted((traffic.HERE / "traffic").glob("*")),
                         ids=lambda p: p.name)
def test_every_mix_names_its_source_and_known_laws(path):
    mix = json.loads(path.read_text())
    assert mix["source"] and mix["why"] and mix["ramp_s"] >= 0
    p = traffic.plan(mix, 1, 100, rate=1.0)
    assert p.prompt_lens and p.output_lens
