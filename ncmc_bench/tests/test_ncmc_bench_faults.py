"""The check on the CPU at a size a test run holds: the frozen slice at its
production size (22,341 atoms, 132 mobile) with a short protocol, R = 2.
The protocol keeps 60 + 20 steps: at 20 + 10 the rotated ligand trips the
cull guard in a third or more of the attempts (non-finite work), which the
check counts as failed.

A sound run is correct and the control (the reference in bfloat16 in the
program's place) is not. Then, with the harness's look for a card skipped
and the program's timed path broken underneath, ``correct`` comes out
false for each fault this cell can have: an iteration that returns its
state unchanged; half of the batch left out, the stats of the other half
reported for it; answers altered where they are produced (an atom of the
end state moved after its energy was taken; the correction left out of the
log acceptance; every attempt's work non-finite, the attempt rejected and
its MD rolled back). A one-chip cell has no exchange between chips to
leave out."""

import copy

import numpy as np
import pytest
import torch

from ncmc_bench import cell, check, run

WORKLOAD = "rotmove-frozen.r256"


def small():
    entry, config, traffic = cell.find(WORKLOAD)
    config = copy.deepcopy(config)
    config["simulation"].update(nstepsNC=60, nstepsMD=20)
    config["minimize_steps"] = 50
    config["system"]["relax_steps"] = 0
    return config, {"replicas": 2}, cell.limits(entry["config"])


def go(seed=20260101, control=False):
    torch.set_num_threads(4)
    config, traffic, limits = small()
    return run.run_config(config, traffic, limits, seed, 40.0, None, "cpu", control=control, warmup_s=0.0), limits


def test_sound_run_is_correct_and_the_control_is_not():
    out, limits = go(control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 6
    ok, rows = check.verdict(out["control"], limits)
    assert not ok, rows


def unchanged(orig):
    def run_iteration_frames(self):
        before = self.state
        out = orig(self)
        self.state = before
        return out
    return run_iteration_frames


def half_left_out(orig):
    from blues_tpu_torch.core.state import SimState
    from blues_tpu_torch.simulation.driver import IterationStats, NCMCFrames

    def run_iteration_frames(self):
        x0, v0, _ = self.state
        stats, md, frames = orig(self)
        h = x0.shape[0] // 2
        x, v, box = (t.clone() for t in self.state)
        x[h:], v[h:] = x0[h:], v0[h:]
        self.state = SimState(x, v, box)

        def rest(t):
            t = t.clone()
            t[h:] = t[:h]
            return t

        return IterationStats(*(rest(t) for t in stats)), md, NCMCFrames(*(rest(t) for t in frames))
    return run_iteration_frames


def altered(orig):
    from blues_tpu_torch.core.state import SimState

    def run_iteration_frames(self):
        out = orig(self)
        x, v, box = self.state
        lig = int(self.system.topology.select_resname("LIG")[-1])  # a hydrogen of the ligand
        x = x.clone()
        x[:, lig, 0] += 0.01
        self.state = SimState(x, v, box)
        return out
    return run_iteration_frames


def correction_dropped(orig):
    def run_iteration_frames(self):
        stats, md, frames = orig(self)
        return stats._replace(log_accept=stats.log_accept - stats.correction), md, frames
    return run_iteration_frames


def every_attempt_failed(orig):
    def run_iteration_frames(self):
        before = self.state
        stats, md, frames = orig(self)
        self.state = before
        nan = torch.full_like(stats.protocol_work, float("nan"))
        stats = stats._replace(accepted=torch.zeros_like(stats.accepted), protocol_work=nan, correction=nan,
                               log_accept=nan, md_failed=torch.ones_like(stats.md_failed))
        return stats, md, frames._replace(work=torch.full_like(frames.work, float("nan")))
    return run_iteration_frames


#: the number each fault has to fail, where one number alone catches it
CAUGHT_BY = {"correction_dropped": "decision_gap", "every_attempt_failed": "failed_share"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered, correction_dropped, every_attempt_failed],
                         ids=lambda f: f.__name__)
def test_faults_come_out_incorrect(monkeypatch, fault):
    from blues_tpu_torch.simulation import BLUESSimulation

    monkeypatch.setattr(BLUESSimulation, "run_iteration_frames", fault(BLUESSimulation.run_iteration_frames))
    out, _ = go()
    assert not out["correct"], out["checks"]
    if fault.__name__ in CAUGHT_BY:
        row = out["checks"][CAUGHT_BY[fault.__name__]]
        assert row["value"] > row["limit"], out["checks"]


def test_a_compared_number_with_no_record_fails():
    ok, rows = check.verdict({"md_energy_gap_kT": None, "constraint_gap": 1e-6},
                             {"md_energy_gap_kT": 1.0, "constraint_gap": 5e-4})
    assert not ok
    assert check.verdict({"md_energy_gap_kT": 0.1, "constraint_gap": 1e-6},
                         {"md_energy_gap_kT": 1.0, "constraint_gap": 5e-4})[0]


def test_decision_gap_reads_the_metropolis_arithmetic():
    beta = 1.0 / 2.4943
    w, corr = np.array([10.0, -3.0, np.nan]), np.array([1.5, -0.25, 0.0])
    la = corr - beta * w
    d = dict(accepted=np.array([False, True, False]), protocol_work=w, correction=corr, log_accept=la)
    assert check.decision_gap([d], beta) == pytest.approx(0.0, abs=1e-15)
    dropped = dict(d, log_accept=-beta * w)
    assert check.decision_gap([dropped], beta) == pytest.approx(1.5 / (1 + 10 * beta + 1.5))
    contradicts = dict(d, accepted=np.array([True, True, True]))  # accepted with a non-finite log acceptance
    assert check.decision_gap([contradicts], beta) == float("inf")
    assert check.decision_gap([], beta) is None
