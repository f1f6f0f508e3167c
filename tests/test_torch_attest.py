"""The device half of ``core/attest.py`` in the port against the JAX
package on the CPU: ``state_digest``/``leaf_digests`` (the digest kernel's
plain route) on the same numpy leaves under the same paths, the
``StateAttestor`` ring, the executor's voted re-dispatch and
``bisect_divergence`` at the JAX tests' shapes (CMA-ES, d 4, pop 8, on
Sphere; ``tests/test_attest.py``). Digests are exact integer words:
every comparison is equality."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.core import attest as jattest
from evox_tpu import GenerationExecutor as JaxExecutor
from evox_tpu import StdWorkflow as JaxStdWorkflow
from evox_tpu.algorithms.so.es import CMAES as JaxCMAES
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu_torch import StdWorkflow
from evox_tpu_torch.algorithms.so.es import CMAES
from evox_tpu_torch.core.attest import (
    IntegrityError,
    StateAttestor,
    bisect_divergence,
    digest_hex,
    host_leaf_digests,
    host_state_digest,
    leaf_digests,
    state_digest,
)
from evox_tpu_torch.core.executor import GenerationExecutor
from evox_tpu_torch.core.instrument import run_report
from evox_tpu_torch.kernels import digest as kd
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows.journal import RunJournal

from tests._chaos import BitFlipStep as JaxBitFlipStep
from tests._chaos import LyingPod as JaxLyingPod
from tests.test_torch_instrument import _check_valid

DIM, POP = 4, 8
NAN_PAYLOADS = np.array([0x7FC00000, 0xFFC00001, 0x7F800001, 0x7FBFFFFF], np.uint32)


def _stress_leaves():
    """numpy leaves of every dtype case: NaN with payloads, +-inf, +-0.0,
    bf16, int64, bool, uint8, empty, 0-d."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal(37).astype(np.float32)
    f32[:4] = NAN_PAYLOADS.view(np.float32)
    f32[4:8] = [np.inf, -np.inf, 0.0, -0.0]
    f64 = rng.standard_normal(9)
    f64[:3] = [np.nan, np.inf, -0.0]
    f16 = rng.standard_normal(11).astype(np.float16)
    f16[:2] = [np.nan, -np.inf]
    bf16 = rng.standard_normal(13).astype(ml_dtypes.bfloat16)
    bf16[:2] = [np.nan, np.inf]
    return {
        "f32": f32.reshape(37, 1),
        "f64": f64,
        "f16": f16,
        "bf16": bf16,
        "i64": rng.integers(-2**62, 2**62, 7),
        "i32": rng.integers(-2**31, 2**31, (3, 5), dtype=np.int32),
        "u8": rng.integers(0, 256, 19, dtype=np.uint8),
        "i8": rng.integers(-128, 128, 6, dtype=np.int8),
        "bool": rng.random(23) < 0.5,
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.float32(2.5),
    }


def _torch_leaf(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _words(t):
    return np.asarray(t).astype(np.uint32) if not isinstance(t, torch.Tensor) \
        else t.numpy().astype(np.uint32)


@pytest.mark.parametrize("name", list(_stress_leaves()))
def test_leaf_digest_equals_jax_on_every_dtype(name):
    """One leaf under its path: the port's plain route equals the JAX
    package's host digest (its exact mirror of the device digest), and the
    JAX device digest where JAX keeps the dtype (x64 is off there, and its
    device digest counts NaN in bf16 where its host digest does not)."""
    leaf = _stress_leaves()[name]
    tree_np, tree_t = {name: leaf}, {name: _torch_leaf(leaf)}
    got = _words(state_digest(tree_t))
    np.testing.assert_array_equal(got, jattest.host_state_digest(tree_np))
    np.testing.assert_array_equal(got, host_state_digest(tree_t))
    if name not in ("i64", "f64", "bf16"):
        np.testing.assert_array_equal(got, np.asarray(jattest.state_digest(tree_np)))
    per = leaf_digests(tree_t)
    assert list(per) == [f"['{name}']"]
    assert digest_hex(_words(per[f"['{name}']"])) == \
        jattest.host_leaf_digests(tree_np)[f"['{name}']"]


def test_whole_state_digest_and_python_scalars_equal_jax():
    """All the stress leaves in one tree (one launch's table on the card),
    with Python-int seeds, a Python float and None, against the JAX
    package's host digest; ints that fit int32 take int32 as
    ``jnp.asarray`` does, larger ones int64 (checked against the JAX
    digest of the int64 leaf)."""
    leaves = _stress_leaves()
    tree_t = {k: _torch_leaf(v) for k, v in leaves.items()}
    tree_t.update(seed=12345, big_seed=2**40 + 7, lr=0.5, none=None)
    tree_np = dict(leaves, seed=12345, big_seed=np.int64(2**40 + 7), lr=0.5, none=None)
    want = jattest.host_state_digest(tree_np)
    np.testing.assert_array_equal(_words(state_digest(tree_t)), want)
    np.testing.assert_array_equal(host_state_digest(tree_t), want)
    theirs = jattest.host_leaf_digests(tree_np)
    ours = {k: digest_hex(_words(v)) for k, v in leaf_digests(tree_t).items()}
    assert ours == theirs == host_leaf_digests(tree_t)
    # the empty tree and a tree of host leaves only
    np.testing.assert_array_equal(_words(state_digest({})), jattest.host_state_digest({}))
    np.testing.assert_array_equal(_words(state_digest({"s": 3})), jattest.host_state_digest({"s": 3}))


def test_plain_route_chains_past_one_table():
    """A state with more tensor leaves than the kernel's table holds: the
    plain route (what the CPU runs) still equals the host digest; on the
    card the wrapper chains launches through a device carry."""
    tree = {f"x{i:03d}": torch.full((3,), float(i)) for i in range(kd.MAX_LEAVES + 5)}
    np.testing.assert_array_equal(_words(state_digest(tree)), host_state_digest(tree))


def _digest_groups(leaves):
    """The launches ``digest_leaves`` makes on the card: MAX_LEAVES leaves
    a launch, each with its plan (as the wrapper plans at 132 SMs)."""
    for lo in range(0, len(leaves), kd.MAX_LEAVES):
        group = leaves[lo:lo + kd.MAX_LEAVES]
        words = [kd.n_words(x) for x in group]
        yield group, words, kd.digest_plan(words)


def _plan_cases():
    rng = np.random.default_rng(5)
    f32 = torch.from_numpy(rng.standard_normal(4096 * 3 + 5).astype(np.float32))
    f64 = torch.from_numpy(rng.standard_normal(2049))
    mixed = [f32, f32[1:], f32[2:2003], f64, f64[1:], torch.zeros(3001, dtype=torch.float16),
             torch.zeros(1025, dtype=torch.uint8), torch.ones(7, dtype=torch.bool),
             torch.zeros(5000, dtype=torch.int64)[3:], torch.zeros(1, dtype=torch.bfloat16)]
    return {
        "mixed widths and offsets": mixed,
        "CSO-shaped, 3 leaves": [torch.zeros(4096 * 64), torch.zeros(4096), torch.zeros(4096 * 64)],
        f"{kd.MAX_LEAVES + 9} small leaves": [torch.zeros(37) for _ in range(kd.MAX_LEAVES + 9)],
        "more chunks than blocks": [torch.zeros(kd.CHUNK_WORDS * 600 + 3)],
    }


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_digest_plan_covers_every_word_once(case):
    """D1's chunk plan: every word of every leaf falls to exactly one
    block's segment, in each launch of a state past ``MAX_LEAVES`` too; no
    block takes more than one chunk over another; the grid is whole waves
    of ``BLOCKS_PER_SM`` an SM, or one block a chunk. Where a segment takes
    16-byte loads (a 4- or 8-byte leaf at a 16-byte aligned address, as
    the kernel decides), its loads start on a whole load and an 8-byte
    element's two words never split between the loads and the word-by-word
    tail, nor between two blocks. The wrapper's table numbers the chunks as
    the plan does."""
    leaves = _plan_cases()[case]
    for group, words, plan in _digest_groups(leaves):
        assert len(group) <= kd.MAX_LEAVES
        rows, chunks, total, _ = kd._table(group, [0] * len(group))  # the wrapper's table
        assert (chunks, list(rows[3::kd.TABLE_ROW]), total) == (plan["chunks"], plan["chunk0"],
                                                                sum(words))
        g = plan["grid"][0]
        assert g == min(kd.BLOCKS_PER_SM * kd.SM_COUNT, plan["chunks"])
        hits = [np.zeros(w, np.int64) for w in words]
        per_block = []
        for b in range(g):
            segs = kd.plan_segments(plan, words, b)
            per_block.append(sum(-(-(w1 - w0) // kd.CHUNK_WORDS) for _, w0, w1 in segs))
            for leaf, w0, w1 in segs:
                x = group[leaf]
                assert w0 % kd.CHUNK_WORDS == 0 and w0 < w1
                hits[leaf][w0:w1] += 1
                if x.element_size() == 8:
                    assert w0 % 2 == 0 and w1 % 2 == 0
                if x.element_size() >= 4 and x.data_ptr() % 16 == 0:
                    assert w0 % 4 == 0  # the loads' first word; the tail from 4 (w1 // 4)
        assert all(bool((h == 1).all()) for h in hits)
        assert max(per_block) - min(per_block) <= 1 and sum(per_block) == plan["chunks"]


def test_cached_salt_equals_the_sha256_salt():
    """The salt of a path, cached a process, is the first four bytes of the
    sha256 of the path, little-endian, as the JAX package takes it, and a
    second call is served from the cache."""
    import hashlib

    from evox_tpu_torch.core.attest import _salt

    names = [".algo.population", ".algo.velocity", ".generation", "['x007']", ".monitors[0].ring"]
    for name in names:
        want = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
        assert _salt(name) == want == jattest._salt(name)
    hits = _salt.cache_info().hits
    assert [_salt(n) for n in names] and _salt.cache_info().hits == hits + len(names)


def test_kernel_word_rewrites_equal_the_plain_words():
    """The three rewrites ``csrc/digest.cu`` makes of a word's arithmetic,
    held on random and special uint32 words in plain numpy: the second mix
    from the first's first step (``mix(x ^ CH2) = finish(h ^ kH2)`` with
    ``h = x ^ x >> 16``, ``kH2 = CH2 ^ CH2 >> 16``), the index product
    carried as an add (``(4q) PHI + j PHI = (4q + j) PHI`` mod 2**32), and
    the float32 NaN/inf test by one compare (``not |x| < inf`` iff the
    exponent is all ones)."""
    rng = np.random.default_rng(11)
    w = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    w[:8] = [0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F800001, 0, 0x80000000, 0x7F7FFFFF]

    def finish(h):
        h = h * np.uint32(kd.MIX1)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(kd.MIX2)
        return h ^ (h >> np.uint32(16))

    h = w ^ (w >> np.uint32(16))
    k_h2 = np.uint32(kd.CH2 ^ (kd.CH2 >> 16))
    assert np.array_equal(finish(h ^ k_h2), jattest._mix32_np(w ^ np.uint32(kd.CH2)))
    assert np.array_equal(finish(h), jattest._mix32_np(w))
    q = rng.integers(0, 2**40, 4096, dtype=np.uint64)
    for j in range(4):
        carried = ((q * 4) * kd.PHI + j * kd.PHI) & 0xFFFFFFFF
        assert np.array_equal(carried, ((q * 4 + j) * kd.PHI) & 0xFFFFFFFF)
    with np.errstate(invalid="ignore"):
        one_compare = ~(np.abs(w.view(np.float32)) < np.float32(np.inf))
    assert np.array_equal(one_compare, (w & 0x7F800000) == 0x7F800000)


def test_a_digest_under_graph_capture_is_refused(monkeypatch):
    """A launch while its stream is being captured into a CUDA graph is
    refused before it reaches the C entry (its scratch is its stream's,
    which the graph's replays would share); off capture the same launch
    reaches the entry on the stream. The card's calls are stand-ins here."""
    calls = []
    monkeypatch.setattr(kd, "_entry", [lambda *args: calls.append(args) or 0])
    monkeypatch.setattr(kd, "_sm_count", lambda index: kd.SM_COUNT)
    monkeypatch.setattr(kd, "_stream_scratch",
                        lambda index, stream: torch.zeros(1, dtype=torch.int32))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    capturing = [True]
    monkeypatch.setattr(torch._C, "_cuda_isCurrentStreamCapturing", lambda: capturing[0],
                        raising=False)
    leaves = [torch.arange(4096, dtype=torch.float32), torch.ones(3, dtype=torch.int64)]
    launch, *_ = kd._prepare(leaves, [1, 2], kd.IDENTITY, None)
    with pytest.raises(RuntimeError, match="captured into a CUDA graph"):
        launch()
    assert calls == []
    capturing[0] = False
    assert launch() == 0 and len(calls) == 1 and calls[0][-1] == 7


# ------------------------------------------------------------------ attestor
def _cma_wf(monitors=()):
    return StdWorkflow(CMAES(np.ones(DIM, np.float32), 1.0, pop_size=POP, device="cpu"),
                       Sphere(), monitors=monitors, device="cpu")


def test_ring_cadence_and_overwrite():
    """every=3 over 12 generations attests at 3, 6, 9, 12; capacity 3 keeps
    the newest three; each ring digest equals the host digest of that
    generation's state (without monitors) from a step loop; a chunked run
    attests the same."""
    att = StateAttestor(every=3, capacity=3, device="cpu")
    wf = _cma_wf(monitors=(att,))
    state = wf.init(4)
    host = {}
    for _ in range(12):
        state = wf.step(state)
        host[state.generation] = digest_hex(host_state_digest(state.replace(monitors=())))
    ledger = att.ledger(state.monitors[0])
    assert [e["generation"] for e in ledger] == [6, 9, 12]
    assert all(e["digest"] == host[e["generation"]] for e in ledger)
    rep = att.integrity_report(state.monitors[0])
    assert rep["enabled"] is True and rep["every"] == 3 and rep["attestations"] == 4
    assert ledger[-1]["digest"] == att.host_digest_hex(state) == att.digest_hex(state)
    chunked = wf.run(wf.run(wf.init(4), 5), 7)
    assert att.ledger(chunked.monitors[0]) == ledger
    report = run_report(wf, state)
    assert report["integrity"]["verdict"] == "clean" and len(report["integrity"]["ring"]) == 3
    _check_valid(report=report)


def _flip(state, leaf, index=0, bit=0):
    """``state`` with one bit flipped in the float32 leaf at dotted path
    ``leaf``."""
    head, _, rest = leaf.partition(".")
    if rest:
        return dataclasses.replace(state, **{head: _flip(getattr(state, head), rest, index, bit)})
    x = getattr(state, head)
    words = x.contiguous().view(torch.int32).reshape(-1).clone()
    words[index] ^= 1 << bit
    return dataclasses.replace(state, **{head: words.view(torch.float32).reshape(x.shape)})


def test_attestation_names_the_flipped_leaf():
    wf = _cma_wf()
    state = wf.run(wf.init(3), 4)
    att = StateAttestor(device="cpu")
    attn = att.attestation(state)
    assert attn["digest"] == att.digest_hex(state)
    assert attn["leaves"] == att.leaf_digest_hex(state)
    bad = _flip(state, "algo.C", index=1)
    assert att.digest_hex(bad) != attn["digest"]
    with pytest.raises(IntegrityError) as err:
        att.verify(bad, attn, generation=4, where="test")
    assert err.value.leaves == (".algo.C",) and err.value.generation == 4
    assert att.verify(state, attn) == attn["digest"]


class LyingRun:
    """``wf.run`` that answers wrongly on scripted call indices:
    ``"perturb"`` flips one mantissa bit of ``leaf`` in the honest result,
    ``"stale"`` returns the previous honest result (``tests/_chaos.py``'s
    ``LyingPod`` for the port's states)."""

    def __init__(self, fn, lies, leaf="algo.mean"):
        self.fn, self.lies, self.leaf = fn, dict(lies), leaf
        self.calls, self._last = 0, None

    def __call__(self, *args, **kwargs):
        flavor = self.lies.get(self.calls)
        self.calls += 1
        result = self.fn(*args, **kwargs)
        if flavor is None:
            self._last = result
            return result
        if flavor == "stale":
            return self._last if self._last is not None else result
        return _flip(result, self.leaf)


@pytest.fixture(scope="module")
def jax_votes():
    """The JAX executor's integrity counters under the same lie schedules
    (one workflow, so its compiled ``run`` serves every schedule)."""
    out = {}
    wf = JaxStdWorkflow(JaxCMAES(center_init=jnp.ones(DIM), init_stdev=1.0, pop_size=POP),
                        JaxSphere())
    honest = wf.run
    for name, lies in (("heal", {2: "perturb"}), ("first", {0: "perturb"}),
                       ("redo", {1: "perturb"}), ("abort", {2: "perturb", 3: "stale"})):
        wf.run = JaxLyingPod(honest, lies=lies, leaf="algo.mean")
        ex = JaxExecutor()
        try:
            ex.run_fused(wf, wf.init(jax.random.PRNGKey(8)), 20, chunk=5, verify_every=1)
        except jattest.IntegrityError:
            pass
        out[name] = ex.integrity_counters()
    return out


@pytest.mark.parametrize("case,lies,dissent", [
    ("heal", {2: "perturb"}, "first"),
    ("first", {0: "perturb"}, "first"),
    ("redo", {1: "perturb"}, "redo"),
])
def test_voted_redispatch_heals_bit_for_bit(jax_votes, case, lies, dissent):
    """A lying dispatch is outvoted 2 of 3 and the healed run equals the
    uninjured one bit for bit; the counters are the JAX executor's under
    the same schedule (verify_every=1: dispatches go chunk 1, its redo,
    chunk 2, ...)."""
    from evox_tpu_torch.workflows.flightrec import FlightRecorder

    straight_wf = _cma_wf()
    straight = straight_wf.run(straight_wf.init(8), 20)
    wf = _cma_wf()
    wf.run = LyingRun(wf.run, lies)
    rec = FlightRecorder()
    ex = GenerationExecutor(metrics=rec)
    att = StateAttestor(device="cpu")
    healed = ex.run_fused(wf, wf.init(8), 20, chunk=5, attest=att, verify_every=1)
    assert att.digest_hex(healed) == att.digest_hex(straight)
    assert torch.equal(healed.algo.mean, straight.algo.mean)
    assert torch.equal(healed.algo.C, straight.algo.C)
    c = ex.integrity_counters()
    assert c == jax_votes[case]
    assert c["mismatches"] == 1 and c["healed"] == 1 and c["aborted"] == 0
    assert c["redispatches"] == c["verified_chunks"] + 2 * c["mismatches"]
    heals = [r for r in rec.tail() if r.get("name") == "integrity.heal"]
    assert len(heals) == 1 and heals[0]["dissent"] == dissent
    report = run_report(wf, healed, executor=ex, metrics=rec)
    assert report["integrity"]["verdict"] == "healed"
    assert report["metrics"]["counters"]["executor.integrity_healed"] == 1
    _check_valid(report=report)


def test_no_majority_aborts_with_integrity_error(jax_votes):
    wf = _cma_wf()
    wf.run = LyingRun(wf.run, {2: "perturb", 3: "stale"})
    ex = GenerationExecutor()
    with pytest.raises(IntegrityError, match="no 2-of-3 majority"):
        ex.run_fused(wf, wf.init(9), 20, chunk=5, verify_every=1)
    c = ex.integrity_counters()
    assert c == jax_votes["abort"]
    assert c["aborted"] == 1 and c["mismatches"] == 1 and c["healed"] == 0
    assert GenerationExecutor().integrity_counters() is None  # the rung never armed


class BitFlipRun:
    """A workflow whose ``run`` flips one bit of ``leaf`` when generation
    ``at_gen`` completes, stepping one generation at a time (the
    reproducible suspect leg)."""

    def __init__(self, wf, leaf, at_gen, index=0):
        self.wf, self.leaf, self.at_gen, self.index = wf, leaf, at_gen, index

    def run(self, state, n_steps):
        for _ in range(int(n_steps)):
            state = self.wf.run(state, 1)
            if state.generation == self.at_gen:
                state = _flip(state, self.leaf, self.index)
        return state


@pytest.fixture(scope="module")
def jax_bisect(tmp_path_factory):
    att = jattest.StateAttestor(every=5, capacity=16)
    wf = JaxStdWorkflow(JaxCMAES(center_init=jnp.ones(DIM), init_stdev=1.0, pop_size=POP),
                        JaxSphere(), monitors=(att,))
    state0 = wf.init(jax.random.PRNGKey(7))
    bad = JaxBitFlipStep(wf, "algo.C", at_gen=13, index=2, bit=0).run(state0, 30)
    journal = RunJournal(str(tmp_path_factory.mktemp("jax_journal")))
    att.journal_ring(bad.monitors[0], journal)
    return jattest.bisect_divergence(
        journal.records(), wf=wf, start_state=state0, attestor=att,
        suspect=JaxBitFlipStep(wf, "algo.C", at_gen=13, index=2, bit=0).run)


def test_bisect_names_exactly_the_injected_generation(tmp_path, jax_bisect):
    """A bit flipped in the covariance at generation 13: the journaled ring
    (cadence 5) splits at 15, and ``bisect_divergence`` names generation
    13 and ``.algo.C``, with the JAX package's report fields; the
    forensics ride the integrity section, which validates."""
    att = StateAttestor(every=5, capacity=16, device="cpu")
    wf = _cma_wf(monitors=(att,))
    state0 = wf.init(7)
    bad = BitFlipRun(wf, "algo.C", 13, index=2).run(state0, 30)
    journal = RunJournal(str(tmp_path / "journal"))
    assert att.journal_ring(bad.monitors[0], journal) == 6
    report = bisect_divergence(str(tmp_path / "journal"), wf=wf, start_state=state0,
                               suspect=BitFlipRun(wf, "algo.C", 13, index=2).run, attestor=att,
                               report_to=wf)
    assert report["first_divergent_generation"] == 13
    assert report["window"] == [11, 15] and report["leaves"] == [".algo.C"]
    assert report["reproducible"] is True and report["verdict"] == "detected"
    for key in ("window", "first_divergent_generation", "leaves", "reproducible", "verdict",
                "attestations_checked", "chunks_replayed", "generations_replayed",
                "barrier_generation", "epoch", "pod_census"):
        assert report[key] == jax_bisect[key], key
    window_only = bisect_divergence(journal, wf=wf, start_state=state0, attestor=att)
    assert window_only["first_divergent_generation"] is None
    assert window_only["window"] == [11, 15]
    rep = run_report(wf, bad)
    assert rep["integrity"]["bisection"]["first_divergent_generation"] == 13
    assert rep["integrity"]["verdict"] == "detected"
    _check_valid(report=rep)
    # an untrusted start state is refused
    with pytest.raises(IntegrityError, match="no trusted barrier"):
        bisect_divergence([{"generation": 0, "digest": "0" * 48}], wf=wf, start_state=state0,
                          attestor=att)


def test_a_cuda_tensor_reaches_the_kernel_or_raises():
    """On the CPU a wrapper takes the plain route only for CPU tensors; a
    leaf on a device the kernel does not run on is refused."""
    with pytest.raises(ValueError, match="cuda or cpu"):
        kd.digest_leaves([torch.zeros(3, device="meta")], [1])
    with pytest.raises(ValueError, match="non-empty"):
        kd.digest_leaves([torch.zeros(0)], [1])
    with pytest.raises(TypeError, match="unsupported"):
        kd.digest_leaves([torch.zeros(2, dtype=torch.complex64)], [1])
    assert kd.digest_leaves.launches == 0
