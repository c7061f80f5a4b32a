"""The paper's contribution: optimal low-rank stochastic gradient
estimation (counterpart of ``repro.core``).

Public API:
  samplers:    sample_v, gaussian, stiefel, coordinate, dependent,
               dependent_from_sigma, dependent_diagonal,
               waterfill_inclusion_probs, systematic_sample
  estimators:  ipa_full, lowrank_ipa, lowrank_ipa_bgrad, lowrank_lr_1pt,
               lowrank_lr_2pt, lowrank_lr_2pt_bgrad, lr_full_2pt,
               lowrank_ipa_pytree_bgrad
  mse:         mse_decomposition, trace_ep2_optimal, trace_ep2_gaussian,
               mse_full_rank, mse_gaussian, mse_isotropic_optimal,
               phi_min_dependent, mse_dependent_optimal, empirical_ep,
               empirical_ep2
"""
from .samplers import (  # noqa: F401
    SAMPLERS, coordinate, dependent, dependent_diagonal, dependent_from_sigma,
    gaussian, sample_v, stiefel, systematic_sample, waterfill_inclusion_probs,
)
from .estimators import (  # noqa: F401
    ipa_full, lowrank_ipa, lowrank_ipa_bgrad, lowrank_ipa_pytree_bgrad,
    lowrank_lr_1pt, lowrank_lr_2pt, lowrank_lr_2pt_bgrad, lr_full_2pt,
)
from .mse import (  # noqa: F401
    empirical_ep, empirical_ep2, mse_decomposition, mse_dependent_optimal,
    mse_full_rank, mse_gaussian, mse_isotropic_optimal, phi_min_dependent,
    trace_ep2_gaussian, trace_ep2_optimal,
)
