"""Build the port's algebraic hierarchy from plain NumPy data.

``algebraic_hierarchy_from_numpy`` takes a hierarchy as a dict of NumPy
arrays and Python metadata (for example one exported from another
implementation) and returns a ``Hierarchy`` on ``device``, so two
implementations can run cycles and solves on identical level data.  The
layout of ``tree``:

    {"levels": [{"A": ell, "P": ell | None, "R": ell | None,
                 "dinv": array, "cheb_lmax": array | None, "n": int,
                 "Aband": band | None, "Pband": band | None,
                 "Rband": band | None, "Ahyb": hyb | None,
                 "Tgeo": geo | None, "color": array | None,
                 "ncolors": int, "Abell": bell | None,
                 "binv": array | None}, ...],
     "coarse_inv": array, "perm": array | None, "iperm": array | None,
     "tail_op": array | None, "tail_start": int, "a0_lo": array | None,
     "a0_lo_band": array | None, "config": {AmgConfig field: value}}

with each ``ell`` a dict ``{"data", "cols", "row_nnz", "shape",
"n_rows_pad", "n_cols_pad"}`` and each ``band`` a dict ``{"vals", "pidx",
"perm", "iperm", "meta", "shape", "reordered", "slot_ranges", "far"}``
(``perm``, ``iperm`` and ``reordered`` absent for a transfer operator;
``far`` None or ``{"rows", "cols", "vals", "meta"}``), each ``hyb`` a dict
``{"planes", "spill": ell | None, "perm", "iperm", "offsets", "shape",
"n_pad"}``, each ``geo`` a dict ``{"wm", "wp", "meta"}`` and each ``bell`` a
dict ``{"data", "cols", "row_nnz", "shape", "bs", "nb_pad"}``; the keys
``color`` to ``binv`` may be absent (None, 1).  Arrays may be ``ml_dtypes``
bfloat16.
"""

from __future__ import annotations

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.bell import BlockEllMatrix
from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.core.hybrid import (BandedMatrix, FarBlock, GeoTransfer,
                                          HybridMatrix, RectBanded)
from raptor_tpu_torch.setup.hierarchy import Hierarchy, Level

__all__ = ["algebraic_hierarchy_from_numpy"]


def _ints(t):
    return tuple(int(v) for v in t)


def _ell(d):
    if d is None:
        return None
    return EllMatrix(data=d["data"], cols=d["cols"], row_nnz=d["row_nnz"],
                     shape=_ints(d["shape"]), n_rows_pad=int(d["n_rows_pad"]),
                     n_cols_pad=int(d["n_cols_pad"]))


def _far(d):
    if d is None:
        return None
    return FarBlock(rows=d["rows"], cols=d["cols"], vals=d["vals"],
                    meta=_ints(d["meta"]))


def _ranges(r):
    return None if r is None else tuple(_ints(lh) for lh in r)


def _band(d):
    if d is None:
        return None
    common = dict(vals=d["vals"], pidx=d["pidx"], meta=_ints(d["meta"]),
                  shape=_ints(d["shape"]), far=_far(d.get("far")),
                  slot_ranges=_ranges(d.get("slot_ranges")))
    if "perm" not in d:
        return RectBanded(**common)
    return BandedMatrix(perm=d["perm"], iperm=d["iperm"],
                        reordered=bool(d["reordered"]), **common)


def _hyb(d):
    if d is None:
        return None
    return HybridMatrix(planes=d["planes"], spill=_ell(d["spill"]),
                        perm=d["perm"], iperm=d["iperm"],
                        offsets=_ints(d["offsets"]), shape=_ints(d["shape"]),
                        n_pad=int(d["n_pad"]))


def _geo(d):
    if d is None:
        return None
    return GeoTransfer(wm=d["wm"], wp=d["wp"], meta=_ints(d["meta"]))


def _bell(d):
    if d is None:
        return None
    return BlockEllMatrix(data=d["data"], cols=d["cols"], row_nnz=d["row_nnz"],
                          shape=_ints(d["shape"]), bs=int(d["bs"]),
                          nb_pad=int(d["nb_pad"]))


def algebraic_hierarchy_from_numpy(tree: dict, device) -> Hierarchy:
    levels = tuple(
        Level(A=_ell(lv["A"]), dinv=lv["dinv"], P=_ell(lv["P"]),
              R=_ell(lv["R"]), color=lv.get("color"),
              cheb_lmax=lv["cheb_lmax"], n=int(lv["n"]),
              ncolors=int(lv.get("ncolors", 1)), Aband=_band(lv.get("Aband")),
              Pband=_band(lv.get("Pband")), Rband=_band(lv.get("Rband")),
              Ahyb=_hyb(lv.get("Ahyb")), Tgeo=_geo(lv.get("Tgeo")),
              Abell=_bell(lv.get("Abell")), binv=lv.get("binv"))
        for lv in tree["levels"]
    )
    hier = Hierarchy(levels=levels, coarse_inv=tree["coarse_inv"],
                     config=AmgConfig(**tree["config"]),
                     perm=tree.get("perm"), iperm=tree.get("iperm"),
                     tail_op=tree.get("tail_op"),
                     tail_start=int(tree.get("tail_start", -1)),
                     a0_lo=tree.get("a0_lo"),
                     a0_lo_band=tree.get("a0_lo_band"))
    return hier.to(device)
