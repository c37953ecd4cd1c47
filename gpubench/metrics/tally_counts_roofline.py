"""tally_counts's share of its roofline over the traced jobs' counted
sweeps (gpubench.roofline.tally_sweep)."""
from gpubench import roofline


def read(ctx):
    return roofline.tally_share(ctx, "tally_counts")
