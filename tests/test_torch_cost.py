"""The port's cost analysis and roofline (``core/cost.py``) against the JAX
package's ``core/xla_cost.py`` on the CPU, the workflows' analysis targets,
and the kernels' work counts against PERF.md's bound column.

``roofline_section`` is held to JAX's on the same synthetic analyses and
timings, classifications and keys exactly. The counts themselves differ by
construction (XLA's HLO cost analysis against the port's operator counter),
so they are checked by their own laws: the matmul family by its formula,
one FLOP an output element elsewhere, views and allocations free."""

import math

import jax.numpy as jnp
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.core import xla_cost as jcost
from evox_tpu_torch import IslandWorkflow, StdWorkflow
from evox_tpu_torch.algorithms.so.pso import PSO
from evox_tpu_torch.core import cost
from evox_tpu_torch.core.problem import Problem
from evox_tpu_torch.kernels import dominance, rollout, rollout_mlp, topk
from evox_tpu_torch.problems.numerical import Sphere

_T = {"seconds": 0.01, "method": "differenced", "latency_confounded": False, "work_pair": [2, 9]}
# synthetic analyses and timings: test_roofline.py:128-147's two cases, and
# one case for each classification
SYNTHETIC = {
    "no_timing": ({"flops": 100.0, "bytes_accessed": 50.0, "memory": None}, None),
    "no_metrics": ({"flops": None, "bytes_accessed": None, "memory": None},
                   {"seconds": 0.01, "method": "differenced"}),
    "compute": ({"flops": 1.5e12, "bytes_accessed": 1e6, "memory": None}, _T),
    "memory": ({"flops": 1e6, "bytes_accessed": 5e9, "memory": None}, _T),
    "dispatch": ({"flops": 1e6, "bytes_accessed": 1e6, "memory": None}, _T),
    "flops_only": ({"flops": 3e12, "bytes_accessed": None, "memory": None}, _T),
    "error": ({"error": "ValueError: boom"}, _T),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_roofline_section_matches_jax(case):
    """Same analyses, timings and ceilings (JAX's, which have no
    ``fp32_tflops``): the same section, key for key."""
    analysis, timing = SYNTHETIC[case]
    summary = {"entry_points": {} if timing is None else {"step": {"per_work_s": timing}}}
    want = jcost.roofline_section({"step": dict(analysis)}, summary, jcost.CHIP_CEILINGS)
    got = cost.roofline_section({"step": dict(analysis)}, summary, jcost.CHIP_CEILINGS)
    assert got == want


def test_roofline_classifies_float32_against_the_fp32_rate():
    """With the port's ceilings, float32 FLOPs are held against 67 TF/s and
    bf16 FLOPs against 989: the same count is compute-bound in float32 and
    dispatch-bound in bf16 at the same time."""
    timing = {"entry_points": {"step": {"per_work_s": _T}}}
    f32 = {"flops": 6.7e11, "bytes_accessed": 1.0, "flops_by_dtype": {"float32": 6.7e11}}
    bf16 = dict(f32, flops_by_dtype={"bfloat16": 6.7e11})
    e32 = cost.roofline_section({"step": f32}, timing)["entries"]["step"]
    e16 = cost.roofline_section({"step": bf16}, timing)["entries"]["step"]
    assert e32["classification"] == "compute-bound" and e32["frac_peak_compute"] == 1.0
    assert e16["classification"] == "dispatch-bound"
    assert math.isclose(e16["frac_peak_compute"], 6.7e11 / 989e12 / 0.01, rel_tol=1e-5)


def test_ceilings_are_the_h100s_own():
    c = cost.CHIP_CEILINGS
    assert (c["mxu_bf16_tflops"], c["fp32_tflops"], c["hbm_gbps"]) == (989.0, 67.0, 3350.0)
    assert "H100" in c["provenance"] and "700 W" in c["provenance"]
    assert set(c) == set(jcost.CHIP_CEILINGS) | {"fp32_tflops"}


def test_counter_counts_matmuls_elementwise_and_skips_views():
    a, b = torch.randn(64, 32), torch.randn(32, 16)

    def f(a, b):
        c = a @ b  # 2 * 64 * 32 * 16
        d = torch.empty(8)  # an allocation: nothing
        e = a.view(-1)[:5]  # views: nothing
        return (c + 1.0).sum(), d, e  # 1024 + 1 output elements

    out = cost.analyze_callable(f, a, b)
    assert out["flops"] == 2 * 64 * 32 * 16 + 1024 + 1
    assert out["ops"] == 3
    # mm reads a and b and writes c; add reads c, writes c + 1; sum reads it
    assert out["bytes_accessed"] == 4 * ((2048 + 512 + 1024) + (1024 + 1024) + (1024 + 1))
    assert out["flops_by_dtype"] == {"float32": out["flops"]}
    assert out["memory"]["argument_bytes"] == 4 * (2048 + 512)


def test_analyze_callable_reports_error_not_raise():
    assert "error" in cost.analyze_callable(lambda x: torch.sum(x) + "nope", torch.ones(4))


def test_analyzer_caches_per_signature():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2.0

    ca = cost.CostAnalyzer()
    ca.analyze("f", f, torch.ones(8))
    ca.analyze("f", f, torch.ones(8))
    assert len(calls) == 1
    ca.analyze("f", f, torch.ones(16))
    assert len(calls) == 2


def test_scalar_values_are_not_signatures():
    """``test_roofline.py::test_scalar_values_are_not_signatures``."""
    a1, s1 = cost.abstract_signature((torch.ones(4), 100))
    a2, s2 = cost.abstract_signature((torch.ones(4), 200))
    assert a1 == a2 and s1 == s2
    assert cost.abstract_signature((torch.ones(4), 1.5))[0] != a1


def test_kernel_charges_reach_the_analysis_in_progress():
    """A kernel wrapper's charge lands in the running analysis, with its
    launch; outside an analysis it goes nowhere."""
    cost.charge("packed_dominance", 1.0, 2.0)  # no analysis: dropped

    def launches():
        cost.charge("packed_dominance", *reversed(dominance.dominance_work(20000, 3)))
        cost.charge("partial_topk", *reversed(topk.topk_work(20000, 10000)))
        return torch.zeros(1)

    out = cost.analyze_callable(launches)
    assert out["kernels"] == {
        "packed_dominance": {"launches": 1, "flops": 3.6e9, "bytes": 50_320_000.0},
        "partial_topk": {"launches": 1, "flops": 20000.0, "bytes": 160_000.0},
    }


def test_work_counts_equal_perf_md_bound_column():
    """PERF.md's kernel table: B3 at n 20000, m 3: 3.6e9 operations and
    50.3 MB; B4 at path 2 (n 20000, k 10000): 160 KB; B4 batched (8, 512,
    1): 16.4 KB; B1 pendulum at path 1 (65536 x 2 x 200): 4.48e9
    operations and 22.8 MB; B2 at path 3 (65536 x 1, 74.88 live steps an
    env): 2.46e11 operations and 5.52 GB."""
    nbytes, ops = dominance.dominance_work(20000, 3)
    assert ops == 3.6e9 and round(nbytes / 1e6, 1) == 50.3
    assert topk.topk_work(20000, 10000) == (160_000, 20000)
    assert round(topk.topk_work(512, 1, rows=8)[0] / 1e3, 1) == 16.4
    nbytes, ops = rollout.rollout_work(65536, 2, 2 * 65536 * 200, 3, 16, 1, "pendulum")
    assert round(ops / 1e9, 2) == 4.48 and round(nbytes / 1e6, 1) == 22.8
    nbytes, ops = rollout_mlp.mlp_rollout_work((244, 64, 64, 17), 65536, 1, round(65536 * 74.88),
                                               25, 17, 5)
    assert round(ops / 1e11, 2) == 2.46 and round(nbytes / 1e9, 2) == 5.52


def _pso_wf(problem=None):
    return StdWorkflow(PSO(-torch.ones(4), torch.ones(4), pop_size=8, device="cpu"),
                       problem if problem is not None else Sphere(), device="cpu")


class _HostSphere(Problem):
    jittable = False

    def evaluate(self, state, pop):
        return (pop ** 2).sum(axis=1), state


def test_std_analysis_targets_step_and_run_at_one_generation():
    wf = _pso_wf()
    state = wf.init(0)
    targets = wf.analysis_targets(state)
    assert set(targets) == {"step", "run"}
    assert targets["run"][1][1] == 1  # one generation
    assert targets["step"][1][0].first_step is False  # the steady state


def test_host_problem_analyses_the_pipeline_halves():
    """``test_roofline.py::test_external_problem_analyzes_pipeline_halves``:
    a host problem's entries are the pipelined halves, each analysed
    without error; the host ``evaluate`` is left out."""
    from evox_tpu_torch.core.instrument import instrument, run_report
    from evox_tpu_torch.workflows.pipelined import run_host_pipelined

    wf = _pso_wf(_HostSphere())
    rec = instrument(wf, analyze=True)
    state = run_host_pipelined(wf, wf.init(0), 4)
    report = run_report(wf, state, recorder=rec)
    entries = report["roofline"]["entries"]
    assert sorted(entries) == ["pipeline_ask", "pipeline_tell"]
    for entry in entries.values():
        assert "error" not in entry["static"]
        assert entry["classification"] in cost.CLASSIFICATIONS
    # PSO's ask hands out the population it holds; its tell does the work
    assert entries["pipeline_tell"]["static"]["flops"] > 0
    assert wf.host_link.counts["d2h"] == 4  # the analysis copied nothing


def test_island_analysis_targets():
    """``test_roofline.py::test_island_workflow_analysis_targets``; islands
    with a host problem give no targets."""
    from evox_tpu_torch.core.instrument import instrument, run_report

    wf = IslandWorkflow(PSO(-torch.ones(4), torch.ones(4), pop_size=8, device="cpu"), Sphere(),
                        n_islands=2, migrate_every=2, device="cpu")
    rec = instrument(wf, analyze=True)
    state = wf.run(wf.init(3), 4)
    entries = run_report(wf, state, recorder=rec)["roofline"]["entries"]
    assert set(entries) == {"step", "run"}
    assert entries["step"]["static"]["flops"] > 0
    assert entries["step"]["classification"] in cost.CLASSIFICATIONS
    host = IslandWorkflow(PSO(-torch.ones(4), torch.ones(4), pop_size=8, device="cpu"),
                          _HostSphere(), n_islands=2, migrate_every=2, device="cpu")
    assert host.analysis_targets(host.init(0)) == {}


def test_jax_analysis_entries_match_the_port_names():
    """Both packages advertise the same entry names for a device problem."""
    import jax

    from evox_tpu import StdWorkflow as JaxStdWorkflow
    from evox_tpu.algorithms.so.pso import PSO as JaxPSO
    from evox_tpu.problems.numerical import Sphere as JaxSphere

    jwf = JaxStdWorkflow(JaxPSO(-jnp.ones(4), jnp.ones(4), pop_size=8), JaxSphere())
    wf = _pso_wf()
    assert (set(jwf.analysis_targets(jwf.init(jax.random.PRNGKey(0))))
            == set(wf.analysis_targets(wf.init(0))))
