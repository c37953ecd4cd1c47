"""Variable updates a second of the window's finished inference jobs:
V x chains x (burn-in + counted sweeps) of each, over the time from the
window's start to the last one's end (the port's observe.throughput
arithmetic)."""


def read(ctx):
    win = ctx["window"]
    if ctx["job"].kind != "infer" or not win.jobs:
        return None
    return sum(u for _, u, _ in win.jobs) / win.seconds
