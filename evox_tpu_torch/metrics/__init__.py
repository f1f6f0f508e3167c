from .igd import IGD, IGDPlus, igd, igd_plus

__all__ = ["IGD", "IGDPlus", "igd", "igd_plus"]
