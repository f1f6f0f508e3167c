from .dataset import DatasetProblem, InMemoryDataLoader, TensorflowDataset

__all__ = ["DatasetProblem", "InMemoryDataLoader", "TensorflowDataset"]
