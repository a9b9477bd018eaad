"""The port must run where jax is not installed: omc_torch imports no jax,
and its sources name neither jax imports nor Pallas."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import omc_torch
import omc_torch.solve  # the driver with the Shor and McCormick paths, and what it imports
import omc_torch.sdp.shor_k
import omc_torch.sdp.mccormick
import omc_torch.api
import omc_torch.utils.checkpoint
import omc_torch.parallel.dist
import omc_torch.parallel.worker
import omc_torch.parallel.mesh
from omc_torch.sdp.admm import init_admm_state, make_admm_solver
from omc_torch.sdp.relax import NodeBatch
from omc_torch.tree import root_box
n = m = 5; k = 1; B = 2; L = 8
rng = np.random.default_rng(0)
A = rng.standard_normal((n, m)); mask = (rng.random((n, m)) < 0.6) * 1.0
lo, hi = root_box(n, k)
t = lambda x: torch.as_tensor(np.ascontiguousarray(x))
batch = NodeBatch(t(np.zeros((B, L, n))), t(np.zeros((B, L, k))), t(np.zeros((B, L, k))),
                  t(np.zeros((B, L))), t(np.broadcast_to(lo, (B, n, k))),
                  t(np.broadcast_to(hi, (B, n, k))))
st = init_admm_state(B, n, m, k, L, torch.float64, device="cpu", rho=0.05)
solve = make_admm_solver(n, m, k, L, 10.0, iters=1, dtype=torch.float64, check_every=1)
fin, out = solve(t(A), t(mask), batch, 10.0, st)
assert np.all(np.isfinite(out["lb_est"].numpy())), out["lb_est"]
from omc_torch.sdp import relax
pd = relax.make_solver(n, m, k, L, 10.0, iters=1, dtype=torch.float64, omega=3.0)
_, pout = pd(t(A), t(mask), batch, 10.0, relax.init_state(B, n, m, k, L, torch.float64,
                                                           device="cpu"))
assert np.all(np.isfinite(pout["Y"].numpy()))
from omc_torch.tree import BBNode
r = omc_torch.api.matrix_completion_SDP_relaxation(
    BBNode(1, 0, lo, hi, -np.inf, 0, cuts=None), n, k, A, mask, 10.0,
    use_disjunctive_cuts=False, iters=2, device="cpu")
assert np.isfinite(r["lower_bound"]), r["lower_bound"]
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
assert "omc" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("NOJAX_OK", int(out["iters_run"][0]))
"""


def test_omc_torch_runs_without_jax():
    env = {key: val for key, val in os.environ.items() if key != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, REPO], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert res.returncode == 0, res.stderr
    assert "NOJAX_OK 1" in res.stdout


def test_sources_name_no_jax_and_no_pallas():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)|pallas", re.IGNORECASE | re.MULTILINE)
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "omc_torch")):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        hits.append(os.path.relpath(path, REPO))
    assert not hits, hits
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        src = fh.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|omc)\b", src, re.MULTILINE)


_WORKER = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["omc"] = None  # and so does any `import omc`
sys.path.insert(0, sys.argv[1])
import socket
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
from omc_torch.parallel import worker
sys.exit(worker.main(["--coordinator", f"localhost:{port}", "--rank", "0", "--world", "1",
                      "--timeout", "60", "--device", "cpu"]))
"""


def test_worker_runs_without_jax_or_omc():
    """The multi-process worker, a world of one over gloo, with jax and omc
    unimportable."""
    env = {key: val for key, val in os.environ.items() if key != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _WORKER, REPO], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert res.returncode == 0, res.stderr
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")][-1]
    assert '"process_count": 1' in line
