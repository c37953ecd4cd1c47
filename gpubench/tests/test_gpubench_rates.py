"""The window counts whole jobs only, and a rate is the finished jobs'
work over the time they took."""
import time
import types

import torch

from gpubench_cells import harness
from gpubench.jobs import Done


class SleepJob:
    kind = "infer"

    def __init__(self, times):
        self.times = list(times)
        self.ran = 0

    def sweeps(self):
        return 10

    def updates(self, V, NC):
        return V * NC * self.sweeps()

    def run(self, s, gen):
        time.sleep(self.times[min(self.ran, len(self.times) - 1)])
        self.ran += 1
        return Done(self.ran, {"i": self.ran})


def setup():
    return types.SimpleNamespace(info=types.SimpleNamespace(n_vars=100),
                                 n_chains=4, device=torch.device("cpu"))


def test_a_job_that_ends_late_is_not_counted():
    job = SleepJob([0.05, 0.05, 0.4])
    win = harness.run_window(setup(), job, 0.3, 1, False, "")
    assert job.ran == 3
    assert len(win.jobs) == 2
    assert win.briefs == [1, 2]
    assert win.seconds < 0.3


def test_no_job_starts_that_cannot_fit():
    job = SleepJob([0.12])
    win = harness.run_window(setup(), job, 0.3, 1, False, "")
    assert job.ran == 2 and len(win.jobs) == 2


def test_rate_is_work_over_time():
    job = SleepJob([0.02])
    win = harness.run_window(setup(), job, 0.25, 3, False, "")
    ctx = dict(job=job, window=win)
    rate = harness.reader("infer_updates_per_s")(ctx)
    assert rate == len(win.jobs) * 100 * 4 * 10 / win.seconds
    assert harness.reader("learn_updates_per_s")(ctx) is None


def test_judged_jobs_are_finished_ones_and_repeat_with_the_seed():
    picks = []
    for _ in range(2):
        job = SleepJob([0.005])
        win = harness.run_window(setup(), job, 0.3, 9, False, "", judged=4)
        assert len(win.kept) == 4 and len(win.jobs) > 8
        for i, keep in win.kept:
            assert 0 <= i < len(win.jobs) and keep == {"i": i + 1}
        picks.append(win.judged)
    assert len(set(win.judged)) == 4


def test_keeping_is_off_the_clock():
    class CopyJob(SleepJob):
        def run(self, s, gen):
            d = super().run(s, gen)
            t = torch.zeros(1)
            t.cpu = lambda: (time.sleep(0.05), torch.zeros(1))[1]
            return Done(d.brief, {"t": t})

    job = CopyJob([0.01])
    win = harness.run_window(setup(), job, 0.2, 2, False, "", judged=64)
    # every finished job was kept; the 50 ms copies are not in the window
    assert len(win.kept) == len(win.jobs)
    assert win.seconds < 0.2
