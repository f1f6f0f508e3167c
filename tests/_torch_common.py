"""Set-up shared by the port's test files (``tests/test_torch_*.py``).

Importing this module gives the process one intra-op thread: the suite runs
in parallel worker processes that share the cores, and a thread pool a
process oversubscribes them (small eager operators then spin, 10-60x
slower). No result depends on the thread count.
"""

import torch

torch.set_num_threads(1)

_JITTED = {}


def jit_once(obj, name):
    """``obj.name`` compiled once by ``jax.jit`` and kept for the process:
    the JAX references' eager op-by-op compiles dominate a file's time
    otherwise. ``obj`` is held beside its compiled method, so its id is
    never reused for another object."""
    import jax

    key = (id(obj), name)
    if key not in _JITTED:
        _JITTED[key] = (obj, jax.jit(getattr(obj, name)))
    return _JITTED[key][1]
