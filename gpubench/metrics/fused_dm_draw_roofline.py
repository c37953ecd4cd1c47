"""fused_dm_draw's share of its roofline over the traced jobs' draws
(gpubench.roofline.draw_sweep: every draw of every sweep)."""
from gpubench import roofline


def read(ctx):
    return roofline.draw_share(ctx, "fused_dm_draw")
