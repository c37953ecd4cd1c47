"""The port's inference and learning on a route a test picks, for the
tests that hold a route other than infer_mc's and learn_mc's to the oracle
or to those: every tier on its eager draw (the color step without a fold:
the single-chain engine's draws, at any chain count), or a tier at a time
(the graph shard's route on one rank holding the whole graph: the dense
deltam tiers a launch each, the hub through hub_color_draw and the delta
mode)."""
import numpy as np
import torch

from sampler_tpu_torch.engine import multichain as tmc


class WholeShard:
    """A graph shard that is the whole graph: rank 0 of 1, nothing to
    reduce or exchange."""
    n_graph, g, psum = 1, 0, None

    def exchange(self, values, c: int, t: int) -> None:
        pass


def infer_on_route(d, info, generator, n_burn: int, n_sweeps: int,
                   n_chains: int, route: str = "eager") -> tuple:
    """(marginals [V, K] float32, worlds [P, n_chains]) as infer_mc gives
    them, ``route`` "eager" or "tiers"."""
    values = tmc.init_values_mc(d, generator, n_chains, info)
    fold = (None if route == "eager"
            else tmc.prepare_fold(d, d.w_init, info, sharded=True))
    shard = None if route == "eager" else WholeShard()
    counts = torch.zeros((info.max_card, values.shape[0]), dtype=torch.int32)
    for i in range(n_burn + n_sweeps):
        tmc.sweep_mc(d, values, d.w_init, generator, False, info, fold,
                     shard)
        if i >= n_burn:
            tmc.tally(counts, values)
    cnt = counts.numpy().T[d.pos_of_vid.numpy()]
    return cnt.astype(np.float32) / np.float32(n_sweeps * n_chains), values


def learn_on_route(d, info, generator, cfg, n_chains: int) -> torch.Tensor:
    """learn_mc's weights with every sweep on the eager draws (the color
    step without a fold); the gradient and the update are learn_mc's."""
    v_ev = tmc.init_values_mc(d, generator, n_chains, info)
    v_free = tmc.init_values_mc(d, generator, n_chains, info)
    w, alpha = d.w_init.clone(), np.float32(cfg.stepsize)
    for _ in range(cfg.n_epochs):
        for _ in range(cfg.n_sweeps_per_epoch):
            tmc.sweep_mc(d, v_ev, w, generator, False, info)
            tmc.sweep_mc(d, v_free, w, generator, True, info)
        grad = tmc.mc_weight_gradient(d, v_ev, v_free,
                                      cfg.learn_non_evidence, info)
        w = tmc.apply_update(w, grad, d.w_fixed, float(alpha),
                             cfg.regularization, cfg.reg_param)
        alpha = alpha * np.float32(cfg.diminish)
    return w
