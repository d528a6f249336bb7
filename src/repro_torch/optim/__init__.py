"""Optimizers and the IHT sparsity projector (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWState, Optimizer, adamw, cosine_schedule
from repro_torch.optim.iht import IHTConfig, maybe_project, project_params, sparsity_report

__all__ = [
    "AdamWState", "Optimizer", "adamw", "cosine_schedule",
    "IHTConfig", "maybe_project", "project_params", "sparsity_report",
]
