"""The port's engine (counterpart of sampler_tpu/engine): the single-chain
entry points and the factor-function evaluation, re-exported as the JAX
package exports them; the multi-chain engine is ``engine.multichain``."""
from .gibbs import infer, init_values, run_inference, run_sweeps
from .learn import LearnConfig, learn
from .sweep import sweep, color_step, color_logits
from .potentials import eval_phi, factor_phis, literals

__all__ = [
    "infer", "init_values", "run_inference", "run_sweeps",
    "LearnConfig", "learn",
    "sweep", "color_step", "color_logits",
    "eval_phi", "factor_phis", "literals",
]
