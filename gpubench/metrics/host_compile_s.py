"""Seconds of the host compile: the coloring (where the program colors),
RCM (where the configuration orders by it) and compile_graph, by the
harness's clock around its calls."""


def read(ctx):
    return ctx["host_compile_s"]
