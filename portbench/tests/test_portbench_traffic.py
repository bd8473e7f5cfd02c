"""The traffic generator: deterministic by seed, the same work under every
seed, and the paper's adapter mix."""
import random
import statistics
from collections import Counter

import pytest

from portbench import traffic
from portbench.harness import load_cell

MIX = load_cell("qwen2.5-32b-l32.batch").mix


def test_adapters_follow_the_power_law_and_fig15_fig8():
    ads = traffic.adapters(MIX["adapters"])
    assert len(ads) == 50
    assert Counter(r for _, r, _ in ads) == {8: 22, 16: 11, 32: 7, 64: 5,
                                             128: 5}
    assert sum(s for *_, s in ads) == pytest.approx(1.0)
    by_rank = Counter()
    for _, r, s in ads:
        by_rank[r] += s
    assert by_rank == pytest.approx({8: 0.38, 16: 0.27, 32: 0.18, 64: 0.11,
                                     128: 0.06})
    heads = [s for aid, _, s in ads if aid.endswith("-a0")]
    assert sum(heads) == pytest.approx(0.724)


def test_jobs_are_deterministic_and_the_same_work_under_every_seed():
    a = traffic.make_jobs(MIX, 200, 1000, 2 ** 31 + 7)
    b = traffic.make_jobs(MIX, 200, 1000, 2 ** 31 + 7)
    c = traffic.make_jobs(MIX, 200, 1000, 12345)
    assert a == b and a != c
    for key in (lambda j: len(j.prompt), lambda j: j.output_len,
                lambda j: j.adapter_id):
        assert Counter(map(key, a)) == Counter(map(key, c))
    p, o = MIX["prompt"], MIX["output"]
    assert all(p["min"] <= len(j.prompt) <= p["max"] and
               o["min"] <= j.output_len <= o["max"] for j in a)
    assert p["max"] + o["max"] <= load_cell(
        "qwen2.5-32b-l32.batch").engine["max_len"]
    # dealt adapter by adapter, so a rank's count is within one per adapter
    # of its share: 0.38 and 0.06 of 200
    shares = Counter(j.rank for j in a)
    assert abs(shares[8] - 76) <= 22 / 2 and abs(shares[128] - 12) <= 5 / 2


def test_lengths_are_truncated_not_piled_on_a_bound():
    spec = {"median": 1000, "sigma": 1.0, "min": 500, "max": 2000}
    got = traffic.lengths(spec, 400, random.Random(0))
    assert 500 <= min(got) and max(got) <= 2000
    # a clip would put about a quarter of them on each bound
    assert Counter(got).most_common(1)[0][1] <= 3
    # within the bounds the quantiles are the lognormal's: its median
    # conditioned on [500, 2000] lies at 1000
    assert statistics.median(got) == pytest.approx(1000, abs=5)


def test_steady_start_opens_on_the_same_work():
    a = traffic.steady_start(MIX, 64, 1000, 1)
    b = traffic.steady_start(MIX, 64, 1000, 2 ** 31 + 99)
    assert sorted((len(j.prompt), j.output_len) for j in a) == \
        sorted((len(j.prompt), j.output_len) for j in b)
    assert a == traffic.steady_start(MIX, 64, 1000, 1)
    assert all(1 <= j.output_len <= MIX["output"]["max"] for j in a)
