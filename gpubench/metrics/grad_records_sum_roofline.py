"""grad_records_sum's share of its roofline over the traced jobs' gradients
(gpubench.roofline.gradient: every epoch's gradient)."""
from gpubench import roofline


def read(ctx):
    return roofline.gradient_share(ctx, "grad_records_sum")
