"""The port's kernels: each wrapper launches its CUDA kernel on a card
tensor and runs its plain PyTorch version on a CPU tensor."""


def kernel_launches() -> dict:
    """Each CUDA kernel's launch count in this process."""
    from .banded import banded_gather, banded_gather_multi
    from .fused import (dm_gather_draw, fused_cat_draw, fused_color_draw,
                        fused_dm_draw)
    from .grad import grad_pair_tile, grad_records, grad_records_sum
    from .tally import tally_counts

    return {k.__name__: k.launches for k in (
        fused_color_draw, banded_gather, grad_pair_tile, fused_dm_draw,
        banded_gather_multi, fused_cat_draw, tally_counts, dm_gather_draw,
        grad_records, grad_records_sum)}
