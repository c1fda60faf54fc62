"""Acceptance configurations 1 and nonsym_gmres of raptor_tpu_torch against
the JAX package on the CPU, at the reference's CI sizes
(tests/integration/test_configs.py): config 1 is RS + Jacobi PCG on the 2D
5-point Poisson 64^2, nonsym_gmres PMIS + Jacobi under restarted GMRES on
the upwind convection-diffusion operator at 32^2.  Each runs in fp64 PCG /
GMRES (the CI form) and in the df64-refined fp32 solve (the bench form).
Checked: the reference's level sizes, its iteration count exactly, and a
true fp64 relres <= 1e-8 against the caller's matrix.
"""

import numpy as np
import pytest

import raptor_tpu.api as japi
import raptor_tpu_torch.api as tapi
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import PRESETS as JPRESETS
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu_torch.config import PRESETS, AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.gallery import (convection_diffusion_2d, default_rhs,
                                      poisson_2d)

FORMS = {"fp64": dict(dtype="float64"), "refined": dict(tol=1e-8, refine=True)}


def _case(name):
    if name == "config1":
        return poisson_2d(64), PRESETS["config1"], JPRESETS["config1"], {}
    cfg = dict(splitting="pmis", smoother="jacobi")
    return (convection_diffusion_2d(32, epsilon=1e-2), TCfg(**cfg),
            JCfg(**cfg), dict(krylov="gmres"))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", ["config1", "nonsym_gmres"])
def test_config_takes_reference_iterations(name, form):
    A, tcfg, jcfg, kry = _case(name)
    sc = dict(FORMS[form], **kry)
    b = default_rhs(A.shape[0])
    jh = japi.setup(A, jcfg, dtype=np.float64 if form == "fp64" else np.float32)
    xj, ji = japi.solve(A, b, jcfg, JSolve(**sc), hier=jh)
    x, ti = tapi.solve(A, b, tcfg, TSolve(**sc), device="cpu")
    assert ti["stats"]["sizes"] == [lv.n for lv in jh.levels]
    assert ti["iterations"] == ji["iterations"]
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    assert ti["stats"]["operator_complexity"] == pytest.approx(
        ji["stats"]["operator_complexity"])
