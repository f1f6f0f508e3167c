"""Supervised-learning problems — the port of
``evox_tpu/problems/supervised/dataset.py``: a population's fitness is each
individual's loss on a stream of data batches.

The data loader lives on the host. Each ``evaluate`` pulls one batch,
copies it to the problem's device through pinned blocks
(``workflows/common.py``'s ``HostLink``) and scores the whole population
there with ``torch.func.vmap(loss_func, in_dims=(0, None))``.

- :class:`InMemoryDataLoader`: shuffled epochs over a tree of numpy arrays
  held in host memory (MNIST and the like), the JAX package's permutation
  stream index for index.
- :class:`DatasetProblem`: any iterator of batch trees.
- :class:`TensorflowDataset`: TFDS and grain behind ``DatasetProblem``;
  import-guarded, since neither package is installed.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device
from ...core.members import in_member_call
from ...core.problem import Problem
from ...utils.common import tree_flatten, tree_map
from ...utils.io import to_x32_if_needed as _to_x32
from ...workflows.common import HostLink


class InMemoryDataLoader:
    """Infinite shuffled-epoch batch iterator over a tree of arrays whose
    leading axis indexes examples. Deterministic given ``seed``: the same
    ``np.random.default_rng(seed)`` permutations as the JAX package's, so
    the batches are equal index for index."""

    def __init__(self, data: Any, batch_size: int, seed: int = 0):
        self.data = tree_map(np.asarray, data)
        n = tree_flatten(self.data)[0][0].shape[0]
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        self.n = n
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._perm = self.rng.permutation(n)
        self._cursor = 0

    def __iter__(self) -> "InMemoryDataLoader":
        return self

    def __next__(self) -> Any:
        if self._cursor + self.batch_size > self.n:
            self._perm = self.rng.permutation(self.n)
            self._cursor = 0
        idx = self._perm[self._cursor : self._cursor + self.batch_size]
        self._cursor += self.batch_size
        return tree_map(lambda x: x[idx], self.data)


class DatasetProblem(Problem):
    """Fitness = ``loss_func(weights, batch)`` of each individual on
    host-fed batches.

    Args:
        iterator: infinite iterator of batch trees (host side).
        loss_func: ``(weights, batch) -> scalar loss`` for one individual,
            in PyTorch.
        valid_iterator: an iterator of held-out batches, or a function of
            no arguments that returns one (called on the first
            :meth:`valid`).
        valid_loss_func: the validation score (default: ``loss_func``).
        device: where the batches go and the loss runs; ``None`` means
            ``"cuda"``.

    Every ``evaluate`` pulls one fresh batch and scores the whole
    population on it; the first call scores the probe batch the
    constructor pulled. The stream is read on the host, in call order, so
    the problem cannot run inside a stacked member call.
    """

    def __init__(
        self,
        iterator: Iterator[Any],
        loss_func: Callable,
        valid_iterator: Optional[Any] = None,
        valid_loss_func: Optional[Callable] = None,
        device: DeviceLike = None,
    ):
        self.loss_func = loss_func
        self.device = resolve_device(device)
        self.host_link = HostLink(self.device)
        self._pending = self._coerce(next(iterator))
        self._iterator = iterator
        self._valid_iterator = valid_iterator
        self._valid_loss_func = valid_loss_func
        self._valid_problem: Optional["DatasetProblem"] = None

    @staticmethod
    def _coerce(batch: Any) -> Any:
        # loaders may yield Python scalars and lists: every leaf becomes an
        # array before the x32 narrowing
        return _to_x32(tree_map(np.asarray, batch))

    def _next_data(self) -> Any:
        if self._pending is not None:
            batch, self._pending = self._pending, None
            return batch
        return self._coerce(next(self._iterator))

    def _to_device(self, batch: Any) -> Any:
        """A host batch as tensors on the device (pinned copies on a card)."""
        return tree_map(self.host_link.to_device, batch)

    def evaluate(self, state, pop, loss_func: Optional[Callable] = None):
        if in_member_call():
            raise NotImplementedError(
                "DatasetProblem reads its data stream on the host in call order, which a "
                "stacked member call cannot batch; evaluate the members one by one"
            )
        data = self._to_device(self._next_data())
        loss = torch.func.vmap(loss_func or self.loss_func, in_dims=(0, None))(pop, data)
        return loss, state

    def valid(self, metric: Optional[Callable] = None) -> Problem:
        """The validation twin over the held-out iterator, for
        ``StdWorkflow.validate``. ``metric`` replaces the scoring function
        (default: ``valid_loss_func`` or the training loss). The twin is
        built once (one probe batch) and kept; a metric view shares the
        twin's stream, so every validation call, whatever its metric,
        advances the same validation iterator."""
        if self._valid_iterator is None:
            raise ValueError(
                "no valid_iterator was provided at construction; pass one "
                "to use validation mode"
            )
        if self._valid_problem is None:
            it = self._valid_iterator
            if callable(it) and not hasattr(it, "__next__"):
                it = it()  # a function: loaders built on the first valid()
            self._valid_problem = DatasetProblem(
                it, self._valid_loss_func or self.loss_func, device=self.device
            )
        if metric is None:
            return self._valid_problem
        return _MetricView(self._valid_problem, metric)


class _MetricView(Problem):
    """A scoring function over its base problem's data stream."""

    def __init__(self, base: DatasetProblem, metric: Callable):
        self.base = base
        self.metric = metric

    def evaluate(self, state, pop):
        return self.base.evaluate(state, pop, loss_func=self.metric)


class TensorflowDataset(DatasetProblem):
    """TFDS and grain behind :class:`DatasetProblem`. Requires
    ``tensorflow-datasets`` and ``grain``, which are optional; constructing
    it without them raises ImportError. Pass ``valid_split="test"`` for
    ``valid()`` over a held-out TFDS split. ``loss_func`` takes PyTorch
    tensors: grain's numpy batches are copied to ``device``."""

    def __init__(
        self,
        dataset: str,
        batch_size: int,
        loss_func: Callable,
        split: str = "train",
        valid_split: Optional[str] = None,
        valid_loss_func: Optional[Callable] = None,
        operations: Optional[list] = None,
        datadir: Optional[str] = None,
        seed: int = 0,
        try_gcs: bool = True,
        device: DeviceLike = None,
    ):
        try:
            import tensorflow_datasets as tfds
            import grain.python as pygrain
        except ImportError as e:
            raise ImportError(
                "TensorflowDataset requires `tensorflow-datasets` and "
                "`grain`; use DatasetProblem + InMemoryDataLoader instead"
            ) from e
        kwargs = {} if datadir is None else {"data_dir": datadir}

        def make_loader(which_split: str, loader_seed: int):
            source = tfds.data_source(dataset, try_gcs=try_gcs, split=which_split, **kwargs)
            sampler = pygrain.IndexSampler(
                num_records=len(source),
                shard_options=pygrain.NoSharding(),
                shuffle=True,
                seed=loader_seed,
            )
            ops = list(operations or []) + [
                pygrain.Batch(batch_size=batch_size, drop_remainder=True)
            ]
            return iter(pygrain.DataLoader(data_source=source, operations=ops,
                                           sampler=sampler, worker_count=0))

        super().__init__(
            make_loader(split, seed),
            loss_func,
            # a function: the held-out split is only read if valid() runs
            valid_iterator=(lambda: make_loader(valid_split, seed + 1)) if valid_split else None,
            valid_loss_func=valid_loss_func,
            device=device,
        )
