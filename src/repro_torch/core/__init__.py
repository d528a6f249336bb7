"""Solver core of the port: the paper's low-precision NIHT (QNIHT), its
baselines and the RIP theory around it, operator backends, thresholding and
metrics (the names of ``repro.core``)."""
from repro_torch.core.baselines import clean, cosamp, fista_l1, iht, spectral_norm
from repro_torch.core.niht import (
    IHTResult,
    IHTTrace,
    SolverState,
    niht,
    niht_iteration,
    qniht,
    qniht_batch,
    qniht_batch_sharded,
    solver_init,
    solver_result,
    solver_segment,
    stopping_iterations,
)
from repro_torch.core.operators import (
    ComposedOperator,
    DenseOperator,
    FakeQuantPairOperator,
    PackedStreamingOperator,
    SubsampledFourierOperator,
    WaveletSynthesisOperator,
    as_operator,
    is_linear_operator,
    make_iteration_operators,
)
from repro_torch.core.recovery import (
    psnr,
    relative_error,
    snr_db,
    source_recovery,
    support_recovery,
)
from repro_torch.core.rip import (
    corollary1_coeffs,
    effective_scale,
    eps_q,
    eps_s,
    gamma_from_rics,
    gamma_full,
    gamma_hat_bound,
    min_bits_lemma1,
    rics_sampled,
    singular_values,
    theorem3_bound,
)
from repro_torch.core.threshold import (
    find_threshold_bisect,
    hard_threshold,
    hard_threshold_bisect,
    support,
    top_s_mask,
)

__all__ = [
    "clean", "cosamp", "fista_l1", "iht", "spectral_norm",
    "IHTResult", "IHTTrace", "SolverState", "niht", "niht_iteration", "qniht",
    "qniht_batch", "qniht_batch_sharded", "solver_init", "solver_result", "solver_segment",
    "stopping_iterations",
    "ComposedOperator", "DenseOperator", "FakeQuantPairOperator",
    "PackedStreamingOperator", "SubsampledFourierOperator",
    "WaveletSynthesisOperator", "as_operator", "is_linear_operator",
    "make_iteration_operators",
    "psnr", "relative_error", "snr_db", "source_recovery", "support_recovery",
    "corollary1_coeffs", "effective_scale", "eps_q", "eps_s",
    "gamma_from_rics", "gamma_full",
    "gamma_hat_bound", "min_bits_lemma1", "rics_sampled", "singular_values",
    "theorem3_bound",
    "find_threshold_bisect", "hard_threshold", "hard_threshold_bisect", "support",
    "top_s_mask",
]
