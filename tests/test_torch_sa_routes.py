"""Why config 4's two SA routes give other level sizes at 324,864 rows,
shown on the CPU at elasticity 10^3 (2,700 rows) against the JAX package.

Both packages' host routes bound lambda_max(D^-1 A), which sets the
prolongator smoothing's omega, by Gershgorin on levels of >= 65536 padded
rows (the reference's raptor_tpu/setup/host_setup.py::_np_estimate_lmax)
and power-iterate below; both device routes always power-iterate.  Here
the switch is moved down to GERSHGORIN_FROM rows, so that it takes level
0 of this input and no other, as 65536 takes level 0 of config 4's bench
input and no other: in the port through host_build_sa_hierarchy's
``gershgorin_rows``, in the reference by handing its own estimator the
level zero-padded to 65536 columns (the Gershgorin bound is a maximum over
columns; the zero columns do not change it).

Tolerances: level sizes exact; A and P within 1e-6 relative between the
host routes (the same NumPy pipeline) and 1e-5 between the device routes
(fp32 power iterations), as tests/test_torch_sa.py.
"""

import dataclasses
import math

import numpy as np
import pytest

import raptor_tpu.api as japi
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import PRESETS as JPRESETS
from raptor_tpu.setup import host_aggregation as jha
from raptor_tpu.setup.host_setup import _np_estimate_lmax as j_estimate_lmax
import raptor_tpu_torch.api as tapi
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.core.ell import ell_to_csr
from raptor_tpu_torch.gallery import elasticity_3d
from raptor_tpu_torch.setup.host_aggregation import host_build_sa_hierarchy as t_host_sa
from raptor_tpu_torch.setup.host_setup import GERSHGORIN_ROWS
from tests._torch_ref import rel_err
from tests.test_torch_sa import TOL, _levels_match, _np_ell

NX = 10
GERSHGORIN_FROM = 2048  # below level 0's 2712 padded rows, above level 1's


def _reference_gershgorin_from(rows: int):
    """The reference's estimator, its Gershgorin branch taken from ``rows``
    padded rows on (it takes it from GERSHGORIN_ROWS)."""
    def estimate(data, cols, dinv, *args, **kwargs):
        n_pad = data.shape[1]
        if rows <= n_pad < GERSHGORIN_ROWS:
            pad = GERSHGORIN_ROWS - n_pad
            data = np.pad(data, ((0, 0), (0, pad)))
            cols = np.pad(cols, ((0, 0), (0, pad)))
            dinv = np.pad(dinv, (0, pad))
        return j_estimate_lmax(data, cols, dinv, *args, **kwargs)
    return estimate


@pytest.fixture(scope="module")
def routes():
    A, B, _ = elasticity_3d(NX)
    cfg = dataclasses.asdict(JPRESETS["config4"])
    dev_cfg = dict(cfg, host_setup_threshold=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jha, "_np_estimate_lmax",
                   _reference_gershgorin_from(GERSHGORIN_FROM))
        j_host_g = jha.host_build_sa_hierarchy(A, JCfg(**cfg), B=B)
    return {
        "A": A,
        "j_host": jha.host_build_sa_hierarchy(A, JCfg(**cfg), B=B),
        "j_host_g": j_host_g,
        "j_device": japi.setup(A, JCfg(**dev_cfg), B=B),
        "t_host_g": t_host_sa(A, TCfg(**cfg), B=B,
                              gershgorin_rows=GERSHGORIN_FROM).to("cpu"),
        "t_host_power": t_host_sa(A, TCfg(**cfg), B=B,
                                  gershgorin_rows=math.inf).to("cpu"),
        "t_device": tapi.setup(A, TCfg(**dev_cfg), B=B, device="cpu"),
    }


def _sizes(h):
    return [lv.n for lv in h.levels]


def _same_operators(th, jh, tol):
    """Level sizes equal; each level's A and P within ``tol`` on their
    logical rows and columns (the two routes pad P apart)."""
    assert _sizes(th) == _sizes(jh)
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        n = tl.n
        a, ja = ell_to_csr(tl.A), ell_to_csr(_np_ell(jl.A))
        assert rel_err(a[:n, :n].toarray(), ja[:n, :n].toarray()) <= tol, i
        if tl.P is not None:
            nc = th.levels[i + 1].n
            p, jp = ell_to_csr(tl.P), ell_to_csr(_np_ell(jl.P))
            assert rel_err(p[:n, :nc].toarray(), jp[:n, :nc].toarray()) <= tol, i


def test_reference_routes_split_on_the_lmax_estimate(routes):
    """The reference's own routes: equal sizes while its host route
    power-iterates, other sizes once it bounds level 0 by Gershgorin."""
    assert routes["j_host"].levels[0].A.n_rows_pad >= GERSHGORIN_FROM
    assert routes["j_host"].levels[1].A.n_rows_pad < GERSHGORIN_FROM
    assert _sizes(routes["j_host"]) == _sizes(routes["j_device"])
    assert _sizes(routes["j_host_g"]) != _sizes(routes["j_device"])
    assert _sizes(routes["j_host_g"])[:2] == _sizes(routes["j_device"])[:2]


@pytest.mark.parametrize("port, reference, tol", [
    ("t_host_g", "j_host_g", TOL[np.float32]),
    ("t_device", "j_device", 10 * TOL[np.float32]),
    ("t_host_power", "j_device", 10 * TOL[np.float32]),
], ids=["host_gershgorin", "device", "host_power_iteration"])
def test_port_routes_split_as_the_reference_does(routes, port, reference, tol):
    """The port's host route with the Gershgorin level is the reference's;
    its device route, and its host route power-iterating on every level
    (phase 19's check in chip_smoke.py), are the reference's device
    route."""
    if port == "t_host_power":
        _same_operators(routes[port], routes[reference], tol)
    else:
        _levels_match(routes[port], routes[reference], tol)
