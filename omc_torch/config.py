"""Solver configuration (port of ``omc/config.py``).

``SolverConfig`` keeps the 25 keyword arguments of the reference entry point
``matrix_completion_branchandbound`` with the same names and defaults
(reference `src/OptimalMatrixCompletion.jl:146-170`), the same eager
validation (reference lines 217-330, including the nulling of inapplicable
knobs before they are echoed into ``run_details``) and the solver knobs of
``omc.config.SolverConfig``.  Two groups of ``omc`` knobs are not carried:
the PDHG step balance ``sdp_omega`` and the per-call duration caps
``sdp_max_call_seconds`` / ``sdp_first_call_iters``.

The port runs the disjunctive-cut ADMM path (linear, linear2 or linear3
cuts, smallest_1_eigvec or smallest_2_eigvec breakpoints), with or without
the Shor valid inequalities (rank 1 and rank k > 1), and the McCormick path
(``use_disjunctive_cuts=False``), under every node selection policy, with
checkpoint/resume, in one process or several (``distributed=True``).  A
valid setting that selects a path the port does not have yet (meshes,
profiling) raises ``NotImplementedError``
naming its ROADMAP item; it never runs some other path instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

_NODE_SELECTIONS = ("breadthfirst", "bestfirst", "depthfirst", "bestfirst_depthfirst")
_CUT_TYPES = ("linear", "linear2", "linear3")
_BREAKPOINTS = ("smallest_1_eigvec", "smallest_2_eigvec")


def not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to omc_torch yet (ROADMAP.md, {item}); "
        "use the omc package for it."
    )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # --- reference-parity knobs (same names & defaults) ---
    node_selection: str = "breadthfirst"
    bestfirst_depthfirst_cutoff: int = 10000
    gap: float = 1e-4
    use_disjunctive_cuts: bool = True
    disjunctive_cuts_type: Optional[str] = None
    disjunctive_cuts_breakpoints: Optional[str] = None
    add_Shor_valid_inequalities: bool = False
    Shor_valid_inequalities_noisy_rank1_num_entries_present: Tuple[int, ...] = (
        1,
        2,
        3,
        4,
    )
    add_Shor_valid_inequalities_fraction: Optional[float] = 1.0
    add_Shor_valid_inequalities_iterative: bool = False
    max_update_Shor_indices_probability: Optional[float] = 1.0
    min_update_Shor_indices_probability: Optional[float] = 0.1
    update_Shor_indices_probability_decay_rate: Optional[float] = 1.1
    update_Shor_indices_n_minors: Optional[int] = 100
    root_only: bool = False
    altmin_flag: bool = True
    max_altmin_probability: Optional[float] = 1.0
    min_altmin_probability: Optional[float] = 0.005
    altmin_probability_decay_rate: Optional[float] = 1.1
    altmin_root_n_iters: int = 1
    use_max_steps: bool = False
    max_steps: int = 1000000
    time_limit: int = 3600
    update_step: int = 1000
    verbosity: int = 1

    # --- solver knobs (meaning as in omc.config.SolverConfig) ---
    batch_size: int = 64  # nodes relaxed simultaneously per device step
    sdp_method: str = "admm"  # only "admm" is ported
    sdp_iters: int = 400  # solver iterations per relaxation super-step
    # ADMM penalty; None => size- and density-scaled default (see solve.py)
    sdp_rho: Optional[float] = None
    sdp_rho_mccormick: float = 10.0
    # ADMM over-relaxation factor
    sdp_alpha: float = 1.9
    sdp_alpha_mccormick: float = 1.6
    # bound refinement: requeue a node (continuing from its own solver
    # state) instead of splitting while its bound is still behind the
    # inherited LB or still moving by more than refine_frac of the
    # remaining local gap, up to max_refines visits
    refine_frac: float = 0.25
    max_refines: int = 12
    # stop refining after this many consecutive visits whose computed bound
    # stayed below the inherited LB
    max_behind_refines: int = 3
    update_Shor_max_growths: int = 8
    # rho portfolio: on refinement visits, padded batch slots carry replicas
    # of the live nodes at these multiples of their ADMM penalty; the
    # per-node max certified bound is taken.  () disables.
    rho_portfolio: Tuple[float, ...] = (0.25, 4.0, 0.0625)
    sdp_warm_start: bool = True  # warm-start children from parent duals
    # children inherit the parent visit's best-chunk duals (refinement
    # re-visits always continue from the raw iterate)
    sdp_best_dual_warm: bool = True
    # when the frontier underfills the batch, raise the per-visit
    # iteration budget by up to this factor
    sdp_iter_boost_max: int = 8
    shor_slot_pow: float = 1.0
    # on-device certification cadence (iterations between safe-bound
    # evaluations and early-exit checks)
    sdp_check_every: int = 1000
    # dual-EMA averaging window (iterations)
    sdp_ema_iters: int = 1000
    sdp_halpern: bool = False
    # above this batch bucket, host float64 certification runs only on the
    # binding slots; the rest keep the on-device margin-guarded bound
    host_certify_max_batch: int = 64
    profile_dir: Optional[str] = None
    profile_steps: int = 3
    altmin_max_iters: int = 100  # matches reference altmin max_iters (line 2000)
    altmin_tol: float = 1e-5  # matches reference eps (line 1998)
    dtype: str = "float32"  # device compute dtype ("float32" | "float64")
    seed: int = 0  # matches reference Random.seed!(0) at line 333
    mesh_shape: Optional[Tuple[int, ...]] = None  # None => single device
    distributed: bool = False
    dist_rebalance_every: int = 4
    dist_migrate_state: bool = True
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 60
    resume: bool = False

    def __post_init__(self):
        if self.sdp_method not in ("admm", "pdhg"):
            raise ValueError(
                'Argument `sdp_method` must be "admm" or "pdhg"; '
                f"{self.sdp_method} supplied instead."
            )
        if self.use_disjunctive_cuts:
            if self.disjunctive_cuts_type not in _CUT_TYPES:
                raise ValueError(
                    "Invalid input for disjunctive cuts type. Disjunctive cuts type "
                    'must be either "linear" or "linear2" or "linear3"; '
                    f"{self.disjunctive_cuts_type} supplied instead."
                )
            if self.disjunctive_cuts_breakpoints not in _BREAKPOINTS:
                raise ValueError(
                    "Invalid input for disjunctive cuts breakpoints. Must be either "
                    '"smallest_1_eigvec" or "smallest_2_eigvec"; '
                    f"{self.disjunctive_cuts_breakpoints} supplied instead."
                )
        if not self.use_disjunctive_cuts:
            # null inapplicable knobs before echoing (reference lines 264-330)
            object.__setattr__(self, "disjunctive_cuts_type", None)
            object.__setattr__(self, "disjunctive_cuts_breakpoints", None)
        if self.node_selection not in _NODE_SELECTIONS:
            raise ValueError(
                "Invalid input for node selection. Node selection must be either "
                '"breadthfirst" or "bestfirst" or "depthfirst" or '
                f'"bestfirst_depthfirst"; {self.node_selection} supplied instead.'
            )
        if self.add_Shor_valid_inequalities:
            frac = self.add_Shor_valid_inequalities_fraction
            if frac is None or not (0.0 <= frac <= 1.0):
                raise ValueError(
                    f"Argument `add_Shor_valid_inequalities_fraction` = {frac} out of bounds [0.0, 1.0]."
                )
        else:
            object.__setattr__(self, "add_Shor_valid_inequalities_fraction", None)

        if self.altmin_flag:
            if not (0.0 <= self.max_altmin_probability <= 1.0):
                raise ValueError(
                    f"Argument `max_altmin_probability` = {self.max_altmin_probability} out of bounds [0.0, 1.0]."
                )
            if not (0.0 < self.min_altmin_probability < 1.0):
                raise ValueError(
                    f"Argument `min_altmin_probability` = {self.min_altmin_probability} out of bounds (0.0, 1.0)."
                )
            if not (1.0 < self.altmin_probability_decay_rate):
                raise ValueError(
                    f"Argument `altmin_probability_decay_rate` = {self.altmin_probability_decay_rate} out of bounds (1.0, inf)."
                )
        else:
            object.__setattr__(self, "max_altmin_probability", None)
            object.__setattr__(self, "min_altmin_probability", None)
            object.__setattr__(self, "altmin_probability_decay_rate", None)

        if (
            self.use_disjunctive_cuts
            and self.add_Shor_valid_inequalities
            and self.add_Shor_valid_inequalities_iterative
        ):
            if not (0.0 <= self.max_update_Shor_indices_probability <= 1.0):
                raise ValueError(
                    f"Argument `max_update_Shor_indices_probability` = "
                    f"{self.max_update_Shor_indices_probability} out of bounds [0.0, 1.0]."
                )
            if not (0.0 < self.min_update_Shor_indices_probability < 1.0):
                raise ValueError(
                    f"Argument `min_update_Shor_indices_probability` = "
                    f"{self.min_update_Shor_indices_probability} out of bounds (0.0, 1.0)."
                )
            if not (1.0 < self.update_Shor_indices_probability_decay_rate):
                raise ValueError(
                    f"Argument `update_Shor_indices_probability_decay_rate` = "
                    f"{self.update_Shor_indices_probability_decay_rate} out of bounds (1.0, inf)."
                )
            if not (1 <= self.update_Shor_indices_n_minors):
                raise ValueError(
                    f"Argument `update_Shor_indices_n_minors` = "
                    f"{self.update_Shor_indices_n_minors} out of bounds [1.0, inf)."
                )
        else:
            object.__setattr__(self, "max_update_Shor_indices_probability", None)
            object.__setattr__(self, "min_update_Shor_indices_probability", None)
            object.__setattr__(self, "update_Shor_indices_probability_decay_rate", None)
            object.__setattr__(self, "update_Shor_indices_n_minors", None)

        if isinstance(
            self.Shor_valid_inequalities_noisy_rank1_num_entries_present, list
        ):
            object.__setattr__(
                self,
                "Shor_valid_inequalities_noisy_rank1_num_entries_present",
                tuple(self.Shor_valid_inequalities_noisy_rank1_num_entries_present),
            )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f'Argument `dtype` must be "float32" or "float64"; {self.dtype} supplied instead.'
            )
        self._check_ported()

    def _check_ported(self):
        """Valid settings of paths the port does not have yet."""
        if self.sdp_method == "pdhg":
            not_ported('sdp_method="pdhg"', '"Not to port"')
        if self.sdp_halpern:
            not_ported("sdp_halpern", '"Not to port"')
        if self.mesh_shape is not None and math.prod(int(s) for s in self.mesh_shape) > 1:
            not_ported("mesh_shape", "queue 1, parallel/mesh.py")
        if self.profile_dir is not None:
            not_ported("profile_dir", "queue 1, profile_dir")

    def run_details_params(self) -> dict:
        """Parameter echo for run_details, matching reference key names
        (reference lines 466-496)."""
        return {
            "node_selection": self.node_selection,
            "bestfirst_depthfirst_cutoff": self.bestfirst_depthfirst_cutoff,
            "optimality_gap": self.gap,
            "root_only": self.root_only,
            "altmin_flag": self.altmin_flag,
            "max_altmin_probability": self.max_altmin_probability,
            "min_altmin_probability": self.min_altmin_probability,
            "altmin_probability_decay_rate": self.altmin_probability_decay_rate,
            "altmin_root_n_iters": self.altmin_root_n_iters,
            "use_max_steps": self.use_max_steps,
            "max_steps": self.max_steps,
            "time_limit": self.time_limit,
            "use_disjunctive_cuts": self.use_disjunctive_cuts,
            "disjunctive_cuts_type": self.disjunctive_cuts_type,
            "disjunctive_cuts_breakpoints": self.disjunctive_cuts_breakpoints,
            "add_Shor_valid_inequalities": self.add_Shor_valid_inequalities,
            "add_Shor_valid_inequalities_fraction": self.add_Shor_valid_inequalities_fraction,
            "add_Shor_valid_inequalities_iterative": self.add_Shor_valid_inequalities_iterative,
            "max_update_Shor_indices_probability": self.max_update_Shor_indices_probability,
            "min_update_Shor_indices_probability": self.min_update_Shor_indices_probability,
            "update_Shor_indices_probability_decay_rate": self.update_Shor_indices_probability_decay_rate,
            "update_Shor_indices_n_minors": self.update_Shor_indices_n_minors,
            "Shor_valid_inequalities_noisy_rank1_num_entries_present": list(
                self.Shor_valid_inequalities_noisy_rank1_num_entries_present
            ),
        }

