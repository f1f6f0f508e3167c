from .gd import GD, GDPlus, gd, gd_plus
from .hypervolume import (
    HV,
    hypervolume_2d,
    hypervolume_3d,
    hypervolume_contributions,
    hypervolume_mc,
)
from .igd import IGD, IGDPlus, igd, igd_plus, masked_igd

__all__ = ["GD", "GDPlus", "HV", "IGD", "IGDPlus", "gd", "gd_plus", "hypervolume_2d",
           "hypervolume_3d", "hypervolume_contributions", "hypervolume_mc", "igd", "igd_plus",
           "masked_igd"]
