"""Variable updates a second of the window's finished learning jobs:
V x chains x 2 worlds x sweeps an epoch x epochs of each, over the time
from the window's start to the last one's end."""


def read(ctx):
    win = ctx["window"]
    if ctx["job"].kind != "learn" or not win.jobs:
        return None
    return sum(u for _, u, _ in win.jobs) / win.seconds
