"""Radiation models (radiationModel::New — reference radiationModel.C):
fvDOM (batched (ray × band) discrete ordinates), P1, viewFactor,
opaqueSolid, none."""

from .fvdom import SIGMA, FvDOM
from .p1 import P1
from .soot import MixtureFractionSoot, make_soot_model

__all__ = ["FvDOM", "P1", "SIGMA", "MixtureFractionSoot", "make_soot_model", "make_radiation"]


def make_radiation(rp, geom, case):
    """Select the radiation model from constant/radiationProperties."""
    if not rp.get_bool("radiation", False):
        return None
    name = str(rp.lookup("radiationModel", "none"))
    if name == "fvDOM":
        return FvDOM.from_case_dict(rp, geom, case)
    if name == "P1":
        return P1.from_case_dict(rp, geom, case)
    if name == "viewFactor":
        from .viewfactor import ViewFactorRadiation

        return ViewFactorRadiation.from_case_dict(rp, geom, case)
    if name == "opaqueSolid":
        from .viewfactor import OpaqueSolid

        return OpaqueSolid.from_case_dict(rp, geom, case)
    return None
