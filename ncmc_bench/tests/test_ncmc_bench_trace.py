"""The reduction of a profiled stretch: busy union, idle gaps by host
activity, kernel names matched as whole identifiers, the breakdown."""

import pytest

import torch

from ncmc_bench.trace import Stretches, breakdown, matches, reduce_events, union


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]


def test_reduce_events():
    kernels = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("c", 95, 130)]
    replays = [("micro", 0, 25), ("micro", 25, 60)]
    out = reduce_events(kernels, (0, 100), replays)
    assert out["busy"] == 20 + 10 + 5
    assert out["window"] == 100
    assert out["kernels"] == 4
    assert out["device_ops"] == {"a": 20, "b": 15, "c": 5}
    assert out["gaps"] == [("micro", 10), ("micro", 55)]
    out = reduce_events(kernels, (0, 100), replays[:1])
    assert out["gaps"] == [("micro", 10), ("between replays", 55)]


def test_kernel_names_match_whole_identifiers():
    assert matches("void (anonymous namespace)::sweep_rows_kernel(Sweep, PairConsts)", ["sweep_rows_kernel"])
    assert matches("cells_kernel(Args, PairConsts)", ["cells_kernel"])
    assert not matches("cells_key_kernel(float const*)", ["cells_kernel"])
    assert not matches("pair_key_kernel(float const*)", ["pair_kernel"])


def test_breakdown_top_entries():
    res = [dict(device_ops={"k1": 2.0, "k2": 1.0}, gaps=[("micro", 0.5)]),
           dict(device_ops={"k1": 1.0, "k3 x": 4.0}, gaps=[("md", 0.7), ("md", 0.1)])]
    b = breakdown(res, top=2)
    assert b["device_ops"] == [["k3_x", 4.0], ["k1", 3.0]]
    assert b["idle_gaps"] == [["md", 0.7], ["micro", 0.5]]
    assert pytest.approx(sum(v for _, v in breakdown(res)["device_ops"])) == 8.0


class Runner:
    """A stand-in graph runner whose replays run a small tensor op and, as
    the real runner does, advance the wrapper's launch counter."""

    def __init__(self, wrapper):
        self.replayed, self.wrapper = [], wrapper

    def replay(self, name):
        self.replayed.append(name)
        self.wrapper.launches += name == "micro"
        torch.ones(64, 64).sum()


class Wrapper:
    name = "MAIN"

    def __init__(self):
        self.launches = 0


def test_stretches_profile_the_planned_replays():
    w = Wrapper()
    runner = Runner(w)
    st = Stretches(runner, [("micro", 2, 3), ("md", 1, 2)], [w])
    for name in ["begin"] + ["micro"] * 8 + ["end"] + ["md"] * 5:
        runner.replay(name)
    st.remove()
    assert runner.replay.__self__ is runner  # the wrapper is gone
    assert [r["phase"] for r in st.results] == ["micro", "md"]
    assert [r["replays"] for r in st.results] == [3, 2]
    # micro replay 2 runs under the profiler outside the stretch; 3-5 are in it
    assert st.results[0]["calls"] == {(0, "MAIN", "launches"): 3}
    assert all(r["window"] > 0 and r["busy"] == 0.0 for r in st.results)  # no device on the CPU
    assert runner.replayed.count("micro") == 8
