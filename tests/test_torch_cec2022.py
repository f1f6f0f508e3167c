"""CEC 2022 F1-F12 of the port against the JAX package, on the CPU, at
every dimension the suite defines (d 2, 10 and 20; the hybrids F6-F8 at
10 and 20), on random points in the box and at each member's optimum; and
the port's copy of the 54 constant files."""

import filecmp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.problems.numerical import cec2022 as jcec
from evox_tpu_torch.problems import numerical as tnum
from evox_tpu_torch.problems.numerical import cec2022 as tcec

REPO = Path(__file__).resolve().parents[1]
# float32 rotations (XLA's and PyTorch's products add in other orders) and
# transcendental routines a few ulps apart, amplified where a member takes
# a fast-varying function of its input (sin(50 s^0.2) in Schaffer F7, the
# Levy and Katsuura terms): at most 2.1e-5 relative in these inputs; 1e-4
# relative. Absolute: 1e-6 for values near 0, except where a Schwefel part
# adds its constant 418.98 k (up to 8380 at d 20, an ulp of 4.9e-4) to a
# sum of like size: near the optimum the difference keeps a few ulps of it
# (1.4e-3 seen): 4e-3 for those members.
RTOL, ATOL = 1e-4, 1e-6
SCHWEFEL_ATOL, SCHWEFEL_MEMBERS = 4e-3, (7, 8, 10, 11, 12)

CASES = [(f, d) for f in range(1, 13) for d in tcec.SUPPORTED_DIMS
         if d in tcec.HYBRID_DIMS or f not in (6, 7, 8)]


def _optimum(problem, d):
    shift = np.asarray(problem.shift)
    return shift[:d] if shift.ndim == 1 else shift[0, :d]


@pytest.mark.parametrize("f,d", CASES)
def test_cec2022_matches_jax(f, d):
    jprob = jcec.CEC2022TestSuite.create(f)
    tprob = tcec.CEC2022TestSuite.create(f, device="cpu")
    x = np.random.default_rng(100 * f + d).uniform(-100.0, 100.0, (32, d)).astype(np.float32)
    x[0] = _optimum(jprob, d)
    x[1] = x[0] + np.float32(1e-3)  # near the optimum
    want = np.asarray(jprob.evaluate(None, jnp.asarray(x))[0])
    got, state = tprob.evaluate(None, torch.from_numpy(x))
    assert state is None and got.dtype == torch.float32 and got.shape == (32,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=SCHWEFEL_ATOL if f in SCHWEFEL_MEMBERS else ATOL)
    # the optimum: 0 (snapped below the round-off floor), or, for F7, F8 and
    # F10, the float32 residue of their Schwefel/Ackley constants (<= 1e-3),
    # as in the JAX package
    assert got[0] == want[0] and (got[0] == 0 or (f in (7, 8, 10) and 0 < got[0] <= 1e-3))


def test_cec2022_data_copy_and_suite():
    ours = REPO / "evox_tpu_torch" / "problems" / "numerical" / "cec2022_data"
    theirs = REPO / "evox_tpu" / "problems" / "numerical" / "cec2022_data"
    names = sorted(p.name for p in theirs.iterdir())
    assert len(names) == 54 and sorted(p.name for p in ours.iterdir()) == names
    _, mismatch, errors = filecmp.cmpfiles(theirs, ours, names, shallow=False)
    assert not mismatch and not errors
    assert Path(tcec._DATA_DIR).resolve() == ours.resolve()
    assert tcec.CEC2022TestSuit is tcec.CEC2022TestSuite
    for i in range(1, 13):
        prob = tcec.CEC2022TestSuite.create(i, device="cpu")
        assert type(prob) is getattr(tnum, f"CEC2022F{i}") and prob.func_num == i
    lb, ub = tcec.F1(device="cpu").bounds(20)
    assert lb.shape == (20,) and float(lb.min()) == -100.0 and float(ub.max()) == 100.0
    with pytest.raises(ValueError, match="defines d in"):
        tcec.F6(device="cpu").evaluate(None, torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="defines d in"):
        tcec.F1(device="cpu").evaluate(None, torch.zeros((2, 5)))


def test_cec2022_refuses_a_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for i in range(1, 13):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcec.CEC2022TestSuite.create(i)
    tcec.F12(device="cpu")
