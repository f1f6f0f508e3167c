from . import evoxbench, neuroevolution, numerical, supervised

__all__ = ["evoxbench", "neuroevolution", "numerical", "supervised"]
