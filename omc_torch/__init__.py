"""omc_torch — certifiably optimal low-rank matrix completion on an NVIDIA
H100, in PyTorch with hand-written CUDA kernels.

A port of the ``omc`` package (JAX), which stays the reference.  The port
runs ``omc``'s single-device paths: the disjunctive-cut branch-and-bound
(linear / linear2 / linear3 cuts at the most negative eigenvector(s) of
``UU' - Y``, every node-selection policy), with or without the Shor valid
inequalities (rank 1 and rank k > 1), and the McCormick bisection path
(``use_disjunctive_cuts=False``); the batched ADMM relaxations run through
the kernels of ``omc_torch/csrc`` on the GPU and their plain torch versions
on the CPU, certification is float64 on the host, altmin supplies upper
bounds, and a run can checkpoint and resume.  The standalone entry points
``alternating_minimization`` and ``matrix_completion_SDP_relaxation`` run
the heuristic or one node's relaxation of any family.  Several processes
can share one frontier (``distributed=True``, ``omc_torch.parallel.dist``
over gloo), a node batch can be split over devices or streams of one card
(``mesh_shape``, ``omc_torch.parallel.mesh``), the driver can write a
profiler trace (``profile_dir``), and ``omc``'s PDHG relaxation
(``sdp_method="pdhg"``) and Halpern-anchored ADMM (``sdp_halpern``) run
too: every configuration ``omc`` accepts runs in the port.

This package imports torch, numpy and scipy only, never jax.
"""

from omc_torch.api import alternating_minimization, matrix_completion_SDP_relaxation
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
from omc_torch.sdp.shor import generate_rank1_matrix_completion_Shor_constraints_indexes
from omc_torch.solve import matrix_completion_branchandbound
from omc_torch.tree import BBNode, BBTree, DisjunctiveCut, ShorInfo

# the reference's exported node-state type names (as omc)
BBNodeDisjunctiveCuts = DisjunctiveCut
BBNodeShorInfo = ShorInfo

__all__ = [
    "matrix_completion_branchandbound",
    "alternating_minimization",
    "matrix_completion_SDP_relaxation",
    "evaluate_objective",
    "compute_SDP_relaxation_objective",
    "compute_MSE",
    "SolverConfig",
    "BBNode",
    "BBTree",
    "DisjunctiveCut",
    "ShorInfo",
    "BBNodeDisjunctiveCuts",
    "BBNodeShorInfo",
    "generate_matrix_completion_data",
    "generate_masked_bitmatrix",
    "generate_sparse_masked_bitmatrix",
    "generate_rank1_matrix_completion_Shor_constraints_indexes",
    "LAUNCHES",
]

__version__ = "0.1.0"
