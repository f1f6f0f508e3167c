from .classification import GPClassification, LaplaceModel, ProbitLabelRegression
from .regression import GPParams, GPRegression

__all__ = ["GPClassification", "GPParams", "GPRegression", "LaplaceModel", "ProbitLabelRegression"]
