"""The port's visualisation against the JAX package's, on the CPU:
``vis_tools.plotly_json`` (equal JSON and HTML), ``vis_tools.plot``
(equal figure data, static and animated, frame by frame),
``EvoXVisMonitor`` (the Arrow file of both monitors driven hook by hook
with the same inputs: schema, metadata but ``begin_time``, and every column
but ``duration``'s values), ``PopMonitor.plot`` for 1, 2 and 3 objectives,
and ``frames2gif`` (the decoded frames of both files). Every comparison is
exact: the same numpy inputs go through the same arithmetic (numpy's, or
none at all) in both packages."""

import jax.numpy as jnp
import matplotlib
import numpy as np
import pyarrow as pa
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import _torch_common  # noqa: F401,E402  (one intra-op thread a worker process)
from evox_tpu.monitors import EvoXVisMonitor as JaxEvoXVisMonitor  # noqa: E402
from evox_tpu.utils.common import frames2gif as jax_frames2gif  # noqa: E402
from evox_tpu.vis_tools import plot as jax_plot  # noqa: E402
from evox_tpu.vis_tools import plotly_json as jax_plotly_json  # noqa: E402
from evox_tpu_torch import StdWorkflow, VectorizedWorkflow  # noqa: E402
from evox_tpu_torch.algorithms.mo import NSGA2  # noqa: E402
from evox_tpu_torch.algorithms.so.pso import PSO  # noqa: E402
from evox_tpu_torch.monitors import EvoXVisMonitor, PopMonitor  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2, ZDT1, Sphere  # noqa: E402
from evox_tpu_torch.utils import frames2gif  # noqa: E402
from evox_tpu_torch.vis_tools import plot, plotly_json  # noqa: E402


def _history(gens, n, m, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((n, m)).astype(np.float32) if m else rng.random(n).astype(np.float32)
            for _ in range(gens)]


def _as_tensors(hist):
    return [torch.from_numpy(h) for h in hist]


# ----------------------------------------------------------- plotly_json


@pytest.mark.parametrize("case", ["dec", "1d", "1d_static", "2d", "2d_sorted", "3d"])
def test_plotly_json_equals_jax(case, tmp_path):
    """The same history (numpy for JAX, tensors for the port) gives the
    same JSON string and the same standalone HTML page."""
    m = {"dec": 2, "1d": 0, "1d_static": 0, "2d": 2, "2d_sorted": 2, "3d": 3}[case]
    hist = _history(4, 9, m, seed=len(case))
    pf = _history(1, 20, max(m, 1), seed=99)[0]
    calls = {
        "dec": lambda mod, h, pf: mod.plot_dec_space(h, title={"text": "x"}),
        "1d": lambda mod, h, pf: mod.plot_obj_space_1d(h),
        "1d_static": lambda mod, h, pf: mod.plot_obj_space_1d(h, animation=False),
        "2d": lambda mod, h, pf: mod.plot_obj_space_2d(h, pf),
        "2d_sorted": lambda mod, h, pf: mod.plot_obj_space_2d(h, sort_points=True),
        "3d": lambda mod, h, pf: mod.plot_obj_space_3d(h, pf),
    }[case]
    want = calls(jax_plotly_json, hist, pf)
    got = calls(plotly_json, _as_tensors(hist), torch.from_numpy(pf))
    assert plotly_json.to_json(got) == jax_plotly_json.to_json(want)
    jax_plotly_json.save_html(want, str(tmp_path / "jax.html"), title="a</b>")
    plotly_json.save_html(got, str(tmp_path / "port.html"), title="a</b>")
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


# ------------------------------------------------------------------ plot


def _figure_data(fig):
    """Everything a figure draws: each axis's lines, scatter offsets (3-D
    ones too), limits, labels and title."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_xlabel(), ax.get_ylabel(), ax.get_title(), ax.get_xlim(), ax.get_ylim()))
        for line in ax.get_lines():
            out.append(("line", line.get_label(), np.asarray(line.get_xdata()).tolist(),
                        np.asarray(line.get_ydata()).tolist()))
        for col in ax.collections:
            offsets = getattr(col, "_offsets3d", None)
            data = ([np.asarray(o).tolist() for o in offsets] if offsets is not None
                    else np.asarray(col.get_offsets()).tolist())
            out.append(("scatter", col.get_label(), data))
    return out


@pytest.mark.parametrize("case", ["dec", "1d", "2d", "3d"])
@pytest.mark.parametrize("animated", [False, True], ids=["static", "animated"])
def test_plot_figures_equal_jax(case, animated):
    m = {"dec": 2, "1d": 0, "2d": 2, "3d": 3}[case]
    hist = _history(3, 7, m, seed=5)
    pf = _history(1, 11, max(m, 1), seed=6)[0]
    calls = {
        "dec": lambda mod, h, pf: mod.plot_dec_space(h, lb=[-1.0, -1.0], ub=[2.0, 2.0],
                                                     animated=animated),
        "1d": lambda mod, h, pf: mod.plot_obj_space_1d(h, animated=animated),
        "2d": lambda mod, h, pf: mod.plot_obj_space_2d(h, pf, animated=animated),
        "3d": lambda mod, h, pf: mod.plot_obj_space_3d(h, pf, animated=animated),
    }[case]
    want = calls(jax_plot, hist, pf)
    got = calls(plot, _as_tensors(hist), torch.from_numpy(pf))
    try:
        if not animated:
            assert _figure_data(got) == _figure_data(want)
            return
        assert hasattr(got, "save")
        for i in range(len(hist)):  # each frame of the animation
            want._func(i)
            got._func(i)
            assert _figure_data(got._fig) == _figure_data(want._fig), i
    finally:
        plt.close("all")


@pytest.mark.parametrize("n_objs", [1, 2, 3])
def test_pop_monitor_plot(n_objs):
    """``PopMonitor.plot`` picks the entry point by the number of
    objectives, as the JAX package's does, on the recorded history."""
    if n_objs == 1:
        mon = PopMonitor(fitness_name="pbest_fitness", fitness_only=True)
        wf = StdWorkflow(PSO(-torch.ones(4), torch.ones(4), 12, device="cpu"), Sphere(),
                         monitors=(mon,), device="cpu")
        want_call = jax_plot.plot_obj_space_1d
    else:
        mon = PopMonitor(fitness_only=True)
        problem = ZDT1(n_dim=6, device="cpu") if n_objs == 2 else DTLZ2(d=6, m=3, device="cpu")
        wf = StdWorkflow(NSGA2(torch.zeros(6), torch.ones(6), n_objs=n_objs, pop_size=12,
                               device="cpu"), problem, monitors=(mon,), device="cpu")
        want_call = jax_plot.plot_obj_space_2d if n_objs == 2 else jax_plot.plot_obj_space_3d
    wf.run(wf.init(3), 4)
    try:
        fig = mon.plot()
        want = want_call(mon.get_fitness_history())
        assert len(mon.get_fitness_history()) == 4
        assert _figure_data(fig) == _figure_data(want)
        assert hasattr(mon.plot(animated=True), "save")
    finally:
        plt.close("all")


# -------------------------------------------------------- EvoXVisMonitor


def _read(path):
    with pa.OSFile(str(path), "rb") as f:
        reader = pa.ipc.open_file(f)
        batches = [reader.get_batch(i) for i in range(reader.num_record_batches)]
        return reader.schema, batches


def _drive(widths, batch_size, record_population, compression, tmp_path, close_after=None,
           dtype=np.float32, m=0):
    """Both monitors' ``post_eval`` on the same candidates and fitness, a
    generation of ``widths[g]`` rows each; returns both files' contents."""
    rng = np.random.default_rng(11)
    jmon = JaxEvoXVisMonitor(out_dir=str(tmp_path / "jax"), batch_size=batch_size,
                             record_population=record_population, compression=compression)
    tmon = EvoXVisMonitor(out_dir=str(tmp_path / "port"), batch_size=batch_size,
                          record_population=record_population, compression=compression)
    for g, n in enumerate(widths):
        pop = rng.standard_normal((n, 3)).astype(dtype)
        fit = rng.standard_normal((n, m) if m else (n,)).astype(np.float32)
        jmon.post_eval(None, {"x": jnp.asarray(pop)}, jnp.asarray(fit))
        tpop = (torch.from_numpy(pop.view(np.int16)).view(torch.bfloat16)
                if pop.dtype.itemsize == 2 else torch.from_numpy(pop))
        tmon.post_eval(None, {"x": tpop}, torch.from_numpy(fit))
        if close_after is not None and g == close_after:
            jmon.close()
            tmon.close()
    jmon.close()
    tmon.close()
    return _read(jmon.path), _read(tmon.path), tmon


def _assert_same_file(want, got):
    (wschema, wbatches), (gschema, gbatches) = want, got
    assert gschema.names == wschema.names
    assert [f.type for f in gschema] == [f.type for f in wschema]
    wmeta, gmeta = dict(wschema.metadata), dict(gschema.metadata)
    assert (b"begin_time" in gmeta) == (b"begin_time" in wmeta)
    wmeta.pop(b"begin_time", None)
    gmeta.pop(b"begin_time", None)
    assert gmeta == wmeta
    assert [b.num_rows for b in gbatches] == [b.num_rows for b in wbatches]  # batch boundaries
    for wb, gb in zip(wbatches, gbatches):
        for name in wschema.names:
            if name == "duration":  # wall-clock offsets: non-decreasing, from 0
                d = gb.column(name).to_pylist()
                assert all(b >= a >= 0.0 for a, b in zip(d, d[1:]))
                continue
            assert gb.column(name).to_pylist() == wb.column(name).to_pylist(), name


@pytest.mark.parametrize("compression", [None, "lz4", "zstd"])
def test_evoxvis_arrow_file_equals_jax(compression, tmp_path):
    """7 generations at batch size 3 (batches of 3, 3 and 1), CSO's double
    first generation (its rows twice as wide), with the population."""
    want, got, mon = _drive([16] + [8] * 6, 3, True, compression, tmp_path)
    _assert_same_file(want, got)
    assert [b.num_rows for b in got[1]] == [3, 3, 1]
    assert got[0].metadata[b"population_size"] == b"8"  # the last row of the first batch
    assert got[0].metadata[b"population_dtype"] == b"float32"
    assert mon.path.name == "evox_0.arrow"


def test_evoxvis_fitness_only_multi_objective_and_close(tmp_path):
    """Fitness only, two objectives; generations after ``close()`` are
    dropped quietly by both; a second monitor takes the next file name."""
    want, got, mon = _drive([6] * 5, 2, False, None, tmp_path, close_after=2, m=2)
    _assert_same_file(want, got)
    assert sum(b.num_rows for b in got[1]) == 3 and "population" not in got[0].names
    again = EvoXVisMonitor(out_dir=str(tmp_path / "port"), batch_size=2)
    assert again.path.name == "evox_1.arrow"
    again.close()


def test_evoxvis_bf16_population_bytes(tmp_path):
    """A bf16 population is written as its raw words under ``"bfloat16"``,
    the JAX package's name and bytes, never as float32."""
    import ml_dtypes

    want, got, _ = _drive([4] * 3, 2, True, None, tmp_path, dtype=ml_dtypes.bfloat16)
    assert got[0].metadata[b"population_dtype"] == b"bfloat16"
    _assert_same_file(want, got)


def test_evoxvis_footer_written_when_flush_raises(tmp_path, monkeypatch):
    mon = EvoXVisMonitor(out_dir=str(tmp_path), batch_size=4, record_population=True)
    mon.post_eval(None, torch.zeros(3, 2), torch.arange(3.0))
    mon.flush()  # one batch written, so the file has a schema
    mon.post_eval(None, torch.zeros(3, 2), torch.arange(3.0))

    def boom(n):
        raise RuntimeError("disk full")

    monkeypatch.setattr(mon, "_write", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        mon.close()
    assert mon.is_closed
    schema, batches = _read(mon.path)  # the footer was written
    assert [b.num_rows for b in batches] == [1]


def test_evoxvis_through_a_workflow_and_the_fleet_refuses_it(tmp_path):
    mon = EvoXVisMonitor(out_dir=str(tmp_path), batch_size=4, record_population=True)
    wf = StdWorkflow(PSO(-torch.ones(5), torch.ones(5), 32, device="cpu"), Sphere(),
                     monitors=(mon,), device="cpu")
    wf.run(wf.init(4), 10)
    mon.close()
    schema, batches = _read(mon.path)
    table = pa.Table.from_batches(batches)
    assert table.column("generation").to_pylist() == list(range(10))
    assert schema.metadata[b"population_size"] == b"32"
    with pytest.warns(UserWarning, match="garbage-collected"):
        EvoXVisMonitor(out_dir=str(tmp_path)).__del__()
    refused = EvoXVisMonitor(out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="EvoXVisMonitor reads the host"):
        VectorizedWorkflow(PSO(-torch.ones(5), torch.ones(5), 8, device="cpu"), Sphere(),
                           n_tenants=2, monitors=(refused,), device="cpu")
    refused.close()


# ------------------------------------------------------------ frames2gif


def test_frames2gif_equals_jax(tmp_path):
    from PIL import Image, ImageSequence

    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (16, 20, 3), dtype=np.uint8) for _ in range(4)]
    jax_frames2gif(frames, str(tmp_path / "jax.gif"), duration=0.05)
    frames2gif([torch.from_numpy(f) for f in frames], str(tmp_path / "port.gif"), duration=0.05)

    def decoded(path):
        with Image.open(path) as im:
            return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]

    want, got = decoded(tmp_path / "jax.gif"), decoded(tmp_path / "port.gif")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
