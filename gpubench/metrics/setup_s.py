"""Seconds from the process's start to the window's start: the graph, the
host compile, the copy to the card, the warm-up job (and, on a
checkout's first run, the kernels' and the host library's builds)."""


def read(ctx):
    return ctx["setup_s"]
