"""omc_torch — certifiably optimal low-rank matrix completion on an NVIDIA
H100, in PyTorch with hand-written CUDA kernels.

A port of the ``omc`` package (JAX), which stays the reference.  The port
runs the disjunctive-cut branch-and-bound main path: best-first selection,
``linear`` cuts at the most negative eigenvector of ``UU' - Y``, the batched
ADMM relaxation (kernels K1-K3 on the GPU, plain torch on the CPU), float64
certification on the host, altmin upper bounds.  Other options of ``omc``
raise ``NotImplementedError`` from ``SolverConfig`` (see ROADMAP.md).

This package imports torch, numpy and scipy only, never jax.
"""

from omc_torch.config import SolverConfig
from omc_torch.data import (
    generate_masked_bitmatrix,
    generate_matrix_completion_data,
    generate_sparse_masked_bitmatrix,
)
from omc_torch.kernels import LAUNCHES
from omc_torch.problem import (
    compute_MSE,
    compute_SDP_relaxation_objective,
    evaluate_objective,
)
from omc_torch.solve import matrix_completion_branchandbound
from omc_torch.tree import BBNode, BBTree, DisjunctiveCut

__all__ = [
    "matrix_completion_branchandbound",
    "evaluate_objective",
    "compute_SDP_relaxation_objective",
    "compute_MSE",
    "SolverConfig",
    "BBNode",
    "BBTree",
    "DisjunctiveCut",
    "generate_matrix_completion_data",
    "generate_masked_bitmatrix",
    "generate_sparse_masked_bitmatrix",
    "LAUNCHES",
]

__version__ = "0.1.0"
