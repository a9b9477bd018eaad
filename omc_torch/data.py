"""Synthetic benchmark instance generation.

Reproduces the generator *semantics* of the reference's orphan utility file
(reference `src/utils.jl:1-111`): rank-k ground truth built from
``n_max``/``m_max`` = 10000 master Gaussian matrices sliced to (n, m) so
instance ``(k, n, m, seed)`` is nested-consistent across sizes, plus masks
guaranteeing at least one observation per row and column, with a
constructive two-stage variant in the sparse regime
(``n_indices < (n+m)*k*log10(n*m)``) and a rejection-sampled variant
otherwise.

Deviation from the reference: the reference draws from Julia's
``MersenneTwister`` (dSFMT) streams; we use numpy's MT19937 via
``numpy.random.Generator``.  The *distribution* and the structural
guarantees are identical, but the streams are not bit-for-bit equal —
bit-parity would require reimplementing dSFMT and Julia's randn ziggurat.
"""

from __future__ import annotations

import numpy as np


def generate_masked_bitmatrix(
    n: int, m: int, sparsity: int, seed: int, *, max_iters: int = 100
) -> np.ndarray:
    """Rejection-sample a boolean (n, m) mask with ``sparsity`` ones.

    Retries up to ``max_iters`` times until every row and column has at
    least one observation (reference `utils.jl:3-26`).
    """
    rng = np.random.default_rng(seed)
    it = 0
    while True:
        flat = np.zeros(n * m, dtype=bool)
        flat[rng.permutation(n * m)[:sparsity]] = True
        # Julia's reshape is column-major; layout choice only permutes which
        # entries are observed, distribution is unchanged.
        indices = flat.reshape((n, m), order="F")
        if (indices.any(axis=0).all() and indices.any(axis=1).all()) or it >= max_iters:
            return indices
        it += 1


def generate_sparse_masked_bitmatrix(
    n: int, m: int, sparsity: int, seed: int
) -> np.ndarray:
    """Constructively sample a mask in the very-sparse regime.

    Stage 1 places max(n, m) entries covering every row and column; stage 2
    fills the remaining ``sparsity - max(n, m)`` uniformly from the unfilled
    positions (reference `utils.jl:28-66`).
    """
    rng = np.random.default_rng(seed)
    indices = np.zeros((n, m), dtype=bool)
    n_filled = max(n, m)
    perm = rng.permutation(n_filled)  # values in 0..n_filled-1
    if n == m:
        for i in range(n):
            indices[i, perm[i]] = True
    elif n < m:
        for j in range(m):
            if perm[j] >= n:
                indices[rng.integers(0, n), j] = True
            else:
                indices[perm[j], j] = True
    else:  # n > m
        for i in range(n):
            if perm[i] >= m:
                indices[i, rng.integers(0, m)] = True
            else:
                indices[i, perm[i]] = True
    options = np.flatnonzero(~indices.reshape(-1))
    extra = sparsity - int(indices.sum())
    if extra > 0:
        chosen = rng.permutation(options)[:extra]
        indices.reshape(-1)[chosen] = True
    return indices


def generate_matrix_completion_data(
    k: int,
    n: int,
    m: int,
    n_indices: int,
    seed: int,
    *,
    n_max: int = 10000,
    m_max: int = 10000,
    noise: float = 0.01,
):
    """Generate ``(A, indices)`` for a rank-``k`` completion benchmark.

    ``A = A_left @ A_right + noise * A_noise`` where the Gaussian factors are
    drawn at size ``(n_max, k)``/``(k, m_max)``/``(n_max, m_max)`` and sliced
    to (n, m), making instances nested-consistent across sizes for a fixed
    seed (reference `utils.jl:68-111`).
    """
    if not (n <= m):
        raise ValueError(
            f"Input matrix A must have size (n, m) with n <= m. n = {n}, m = {m} supplied instead."
        )
    if n_indices < (n + m) * k:
        raise ValueError(
            "System is under-determined. n_indices must be at least (n + m) * k."
        )
    if n_indices > n * m:
        raise ValueError(
            "Cannot generate random indices of length more than the size of matrix A."
        )
    # 4 derived sources of randomness, as in the reference
    seeds = np.random.default_rng(seed).integers(0, 2**31 - 1, size=4)
    A_left = np.random.default_rng(int(seeds[0])).standard_normal((n_max, k))[:n, :]
    A_right = np.random.default_rng(int(seeds[1])).standard_normal((k, m_max))[:, :m]
    A = A_left @ A_right
    A_noise = np.random.default_rng(int(seeds[2])).standard_normal((n_max, m_max))[
        :n, :m
    ]
    A = A + noise * A_noise

    if (n + m) * k <= n_indices < int(np.ceil((n + m) * k * np.log10(n * m))):
        indices = generate_sparse_masked_bitmatrix(n, m, n_indices, int(seeds[3]))
    else:
        indices = generate_masked_bitmatrix(n, m, n_indices, int(seeds[3]))
    return A, indices
