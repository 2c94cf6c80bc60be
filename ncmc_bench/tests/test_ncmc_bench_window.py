"""The window: whole iterations, the stop rule, the rate, and the failure
below three iterations, with a stand-in simulation of fixed iteration time
on a stand-in clock."""

import pytest

from ncmc_bench.window import MIN_ITERATIONS, WARMUP_S, WindowTooShort, rate, run_window, warm_up


class FakeSim:
    """Iterations of fixed length on a clock it advances."""

    def __init__(self, length, start=100.0):
        self.t, self.length, self.iterations = start, length, 0

    def clock(self):
        return self.t

    def step(self):
        self.t += self.length
        self.iterations += 1


@pytest.mark.parametrize("length,seconds,n", [(2.0, 10.0, 5), (3.0, 10.0, 3), (2.5, 10.0, 4), (0.4, 1.0, 2)])
def test_whole_iterations_that_end_by_seconds(length, seconds, n):
    sim = FakeSim(length)
    if n < MIN_ITERATIONS:
        with pytest.raises(WindowTooShort):
            run_window(sim.step, seconds, length, sim.clock)
        return
    lengths, window = run_window(sim.step, seconds, length, sim.clock)
    assert len(lengths) == n == sim.iterations
    assert window == pytest.approx(n * length)
    assert window <= seconds  # the window ends by --seconds
    assert window + length > seconds  # and holds every iteration that fits


def test_stop_rule_uses_the_last_iteration():
    """Iterations that slow down stop the window as soon as the last one's
    length would overrun."""
    t = [0.0]
    lens = iter([1.0, 1.0, 3.0, 3.0, 3.0])

    def step():
        t[0] += next(lens)

    lengths, window = run_window(step, 6.0, 1.0, lambda: t[0])
    assert lengths == [1.0, 1.0, 3.0]
    assert window == 5.0


def test_first_iteration_judged_by_the_estimate():
    sim = FakeSim(2.0)
    with pytest.raises(WindowTooShort):
        run_window(sim.step, 10.0, 11.0, sim.clock)
    assert sim.iterations == 0


def test_rate_counts_every_attempt_over_the_window():
    assert rate(256, [2.0, 2.0, 2.0], 6.0) == pytest.approx(128.0)
    assert rate(8, [1.0, 1.5, 2.0, 1.5], 6.0) == pytest.approx(32 / 6.0)


@pytest.mark.parametrize("lengths,n", [
    ([9.5, 7.7, 7.7, 7.7], 3),  # the frozen slice at R = 256: the capture, then 2
    ([6.5, 4.77, 4.76, 4.76, 4.58, 4.27], 5),  # R = 8 in the slow start
    ([13.0, 11.4, 11.4], 2),  # R = 32
    ([30.0, 1.0], 1),  # an iteration longer than the warm-up: one
])
def test_warm_up_lasts_a_fixed_time_in_whole_iterations(lengths, n):
    t, it = [0.0], iter(lengths)

    def step():
        t[0] += next(it)

    got = warm_up(step, WARMUP_S, lambda: t[0])
    assert got == pytest.approx(lengths[:n])
    assert sum(got) >= WARMUP_S and sum(got[:-1]) < WARMUP_S
