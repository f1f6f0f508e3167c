from .sbx import SimulatedBinary, simulated_binary

__all__ = ["SimulatedBinary", "simulated_binary"]
