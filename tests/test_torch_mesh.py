"""Parity of the port's node-batch split (omc_torch.parallel.mesh and the
driver's ``mesh_shape``) with omc.parallel.mesh, on 8 CPU shards (omc's
tests run the same split on 8 virtual CPU devices, tests/test_parallel.py).

Inputs come from numpy seeds, float64.  Each shard runs the batched solver
on its contiguous slots; the joined outputs must equal one device's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.parallel import mesh as jmesh
from omc.sdp import admm as jadmm
from omc.sdp import relax as jrelax
from omc.solve import matrix_completion_branchandbound as omc_bnb
from omc.tree import root_box

from omc_torch import convert
from omc_torch.parallel import mesh as tmesh
from omc_torch.sdp import admm as tadmm
from omc_torch.sdp import relax as trelax
from omc_torch.solve import matrix_completion_branchandbound

torch.set_num_threads(2)

_MAIN = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
             disjunctive_cuts_breakpoints="smallest_1_eigvec")


def test_make_mesh_and_placement():
    """make_mesh cycles over its devices (two shards on one device are two
    entries); put_sharded checks that the mesh divides the node axis; a
    CUDA mesh without a GPU raises."""
    mesh = tmesh.make_mesh(3, device="cpu")
    assert mesh == [torch.device("cpu")] * 3
    assert tmesh.make_mesh(4, devices=["cpu", "meta"]) == [torch.device(d) for d in
                                                          ("cpu", "meta", "cpu", "meta")]
    x = torch.arange(6.0)
    assert torch.equal(tmesh.put_sharded(mesh, x), x)
    with pytest.raises(ValueError, match="divisible"):
        tmesh.put_sharded(tmesh.make_mesh(4, device="cpu"), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(2)


def test_shard_solver_matches_single_device_and_omc():
    """tests/test_parallel.py's check on the port: 8 CPU shards, n = m = 8,
    B = 8, 200 iterations, +inf targets (no slot exits early).  Y and the
    host-certified bound against one device and against omc's shard_solver
    on 8 virtual devices, 1e-8."""
    n = m = 8
    k, gamma, L, B = 1, 40.0, 4, 8
    A, idx = generate_matrix_completion_data(k, n, m, 40, seed=0)
    mask = idx.astype(np.float64)
    ub = 0.5 * float(np.sum(mask * A * A))
    lo, hi = root_box(n, k)
    leaves = [np.zeros((B, L, n)), np.zeros((B, L, k)), np.zeros((B, L, k)), np.zeros((B, L)),
              np.broadcast_to(lo, (B, n, k)).copy(), np.broadcast_to(hi, (B, n, k)).copy()]
    target = np.full(B, np.inf)
    group = np.arange(B, dtype=np.int32)

    mesh = tmesh.make_mesh(8, device="cpu")
    raw = tadmm.make_admm_solver(n, m, k, L, gamma, iters=200, dtype=torch.float64)
    step = tmesh.shard_solver(mesh, raw, extra_sharded=2)
    batch = convert.node_batch_from_numpy(leaves, device="cpu")
    st0 = tadmm.init_admm_state(B, n, m, k, L, torch.float64, device="cpu")
    batch_s, st_s = tmesh.shard_batch(mesh, batch, st0)
    state, out = step(torch.as_tensor(A), torch.as_tensor(mask), batch_s, ub, st_s, 200,
                      tmesh.put_sharded(mesh, torch.as_tensor(target)),
                      tmesh.put_sharded(mesh, torch.as_tensor(group)))
    assert isinstance(state, tadmm.ADMMState) and state.w1.shape[0] == B
    assert np.isfinite(out["lb_dev"].numpy()).all()
    assert (out["iters_run"].numpy() == 200).all()

    solver = tadmm.make_admm_solver(n, m, k, L, gamma, iters=200, dtype=torch.float64)
    _, out1 = solver(torch.as_tensor(A), torch.as_tensor(mask), batch, ub, st0, 200,
                     torch.as_tensor(target), torch.as_tensor(group))
    np.testing.assert_allclose(out["Y"].numpy(), out1["Y"].numpy(), rtol=1e-8, atol=1e-8)

    jm = jmesh.make_mesh(8)
    jstep = jmesh.shard_solver(jm, jadmm.make_admm_solver(n, m, k, L, gamma, iters=200,
                                                           dtype=jnp.float64, rho=0.05,
                                                           jit=False), extra_sharded=2)
    jb = jrelax.NodeBatch(*[jnp.asarray(x) for x in leaves])
    jb_s, jst_s = jmesh.shard_batch(jm, jb, jadmm.init_admm_state(B, n, m, k, L, jnp.float64))
    _, outj = jstep(jnp.asarray(A), jnp.asarray(mask), jb_s, ub, jst_s, 200,
                    jmesh.put_sharded(jm, jnp.asarray(target)),
                    jmesh.put_sharded(jm, jnp.asarray(group)))
    np.testing.assert_allclose(out["Y"].numpy(), np.asarray(outj["Y"]), rtol=1e-8, atol=1e-8)

    lbs = [trelax.host_certified_bound(A, mask, batch, o, gamma, k, ub) for o in (out, out1)]
    lbs.append(jrelax.host_certified_bound(A, mask, jrelax.NodeBatch(*leaves),
                                           {kk: np.asarray(v) for kk, v in outj.items()},
                                           gamma, k, ub))
    np.testing.assert_allclose(lbs[0], lbs[1], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(lbs[0], lbs[2], rtol=1e-8, atol=1e-8)


_PATHS = {
    # tests/test_parallel.py:72, and its :94 and :108 at instances and
    # budgets that certify within a few visits (every visit under the mesh
    # runs the full batch, one shard after another on the CPU)
    "base": ((1, 10, 10, 60, 2), 20.0, dict(_MAIN, gap=1e-2, sdp_iters=600)),
    "mccormick": ((1, 6, 6, 18, 3), 20.0, dict(use_disjunctive_cuts=False,
                                              node_selection="bestfirst", gap=5e-2,
                                              sdp_iters=300, sdp_iter_boost_max=1)),
    "shor": ((1, 8, 8, 44, 4), 20.0, dict(_MAIN, add_Shor_valid_inequalities=True,
                                         add_Shor_valid_inequalities_iterative=True,
                                         update_Shor_indices_n_minors=6, gap=5e-2,
                                         sdp_iters=300, sdp_iter_boost_max=1)),
}


@pytest.mark.parametrize("path", list(_PATHS))
def test_driver_mesh_matches_single_device_and_omc(path):
    """The driver at mesh_shape=(8,) (batch 8, one slot a shard): the same
    certified objective as one device and as omc at mesh_shape=(8,), 1e-6
    relative, with the shards named in run_details."""
    args, gamma, kw = _PATHS[path]
    A, idx = generate_matrix_completion_data(*args)
    kw = dict(kw, batch_size=8, dtype="float64", time_limit=180, verbosity=0)
    sol8, _, inst8 = matrix_completion_branchandbound(1, A, idx, gamma, device="cpu",
                                                      mesh_shape=(8,), **kw)
    assert inst8["run_details"]["mesh_devices"] == ["cpu"] * 8
    assert inst8["run_log"][-1]["gap"] <= kw["gap"]
    sol1, _, inst1 = matrix_completion_branchandbound(1, A, idx, gamma, device="cpu", **kw)
    assert "mesh_devices" not in inst1["run_details"]
    solj, _, instj = omc_bnb(1, A, idx, gamma, mesh_shape=(8,), **kw)
    assert sol8["objective"] == pytest.approx(sol1["objective"], rel=1e-6)
    assert sol8["objective"] == pytest.approx(solj["objective"], rel=1e-6)


def test_driver_mesh_refuses_like_omc():
    """A batch the mesh does not divide raises ValueError; a mesh with the
    PDHG solver raises omc's own NotImplementedError."""
    A, idx = generate_matrix_completion_data(1, 6, 6, 20, seed=0)
    kw = dict(_MAIN, dtype="float64", sdp_iters=50, verbosity=0)
    with pytest.raises(ValueError, match="divisible"):
        matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu", batch_size=6,
                                         mesh_shape=(4,), **kw)
    for fn, extra in ((matrix_completion_branchandbound, dict(device="cpu")), (omc_bnb, {})):
        with pytest.raises(NotImplementedError, match="requires the ADMM solver family"):
            fn(1, A, idx, 20.0, batch_size=4, mesh_shape=(2,), sdp_method="pdhg", **extra,
               **kw)
