"""Radiation models (radiationModel::New — reference radiationModel.C):
fvDOM (batched (ray × band) discrete ordinates) or none."""

from .fvdom import SIGMA, FvDOM
from .soot import MixtureFractionSoot, make_soot_model

__all__ = ["FvDOM", "SIGMA", "MixtureFractionSoot", "make_soot_model", "make_radiation"]


def make_radiation(rp, geom, case):
    """Select the radiation model from constant/radiationProperties."""
    if not rp.get_bool("radiation", False):
        return None
    name = str(rp.lookup("radiationModel", "none"))
    if name == "fvDOM":
        return FvDOM.from_case_dict(rp, geom, case)
    if name != "none":
        raise NotImplementedError(f"the benchmark's reference has no {name}")
    return None
