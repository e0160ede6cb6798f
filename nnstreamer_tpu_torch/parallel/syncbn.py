"""Batch statistics over every data shard of a training step (sync batch
norm): the cross-shard moments, and nothing else.

The JAX package has no counterpart: its ``train_step`` is one SPMD
program, and XLA all-reduces each train-mode ``mean``/``var`` over the
data shards.  The port's step (``parallel/sharded.py`` ``TrainStep``)
runs each data shard's forward on its own host thread, on its lead
record's ``torch.device``; every batch-norm statistic of the port's
models passes through :func:`batch_moments`
(``models/mobilenet.py`` ``ConvBN``), which combines the shards' moments
when the calling thread runs a shard of a :class:`ShardGroup`.

One exchange a layer: each shard posts ``(n_k, mean_k, var_k)`` of its
rows (``mean`` and ``var``, the functions the stacked step takes, so the
formula below gives a lone shard's own moments bit for bit: its weight
is exactly 1 and ``mean_k − μ`` exactly 0), with a CUDA event recorded
behind it on the poster's stream where the rows lie on a card, and
waits at the group's barrier; then each shard copies every posted pair
to its own device and combines them by Chan's formula,

    μ  = Σ n_k·mean_k / N
    σ² = Σ n_k·(var_k + (mean_k − μ)²) / N,

the global batch's mean and population variance.  A copy is ordered only
against the copying thread's current stream on the source device, and
the poster's kernels run on its own (a split step runs each shard on its
caller's current stream: ``parallel/sharded.py``), so the reader's
current stream on the poster's device waits on the poster's event before
the copy, and the posted tensors are marked in use on that stream.  All
of it is torch ops
and ``.to()`` copies, so autograd carries each shard's gradient through
the other shards' statistics; no backward is written by hand.

Across processes (a mesh whose data shards lie on more than one rank,
:class:`RankShards`) a layer takes one exchange more: after the barrier
the lead shard (shard 0, the step's calling thread) writes its rank's
``(mean_k, var_k)`` rows into a zero-filled ``(S_global, 2C)`` buffer at
their global shard indices and all-reduces it over the rank's data peers
(SUM, exact: each entry has one non-zero term); every local shard waits
at a second barrier, then reads the buffer and combines all S_global
shards by the same formula in global shard order.  The data peers are
the ranks that hold this rank's ``model`` coordinates: every rank where
no ``model`` group spans ranks, else one rank of each data shard's model
group (``make_mesh("model:2,data:4")`` over two ranks: each rank alone,
running all four shards).  So a shard whose model group spans M ranks
has its row written once in each set of peers, not M times, and each of
its M ranks reads it.  The exchange is a ``torch.autograd.Function``
(:class:`RankExchange`) whose backward all-reduces the gradient buffer
over the same peers and keeps the rank's own rows, so each rank's rows
get the gradient of every peer's loss through the statistics, each data
shard's once.  One thread a rank issues each collective, and every rank
issues them in one order: the forward's in layer order, the backward's
in reverse, since all of a step's exchange nodes sit on the lead shard's
device and each layer's statistics depend on the layer before (a chain
of batch-norm layers: every model of the port).

:meth:`ShardGroup.join` is the same rendezvous for another layer: the
lead applies one function to every local shard's tensor (the split
step's input-gradient reduction over a cross-rank ``model`` group,
``parallel/sharded.py``), so that reduction too is one node a layer whose
collectives every rank issues in shard order.

A shard that raises aborts the barrier, so the others raise
:class:`ShardGroupError` instead of waiting; a barrier that waits longer
than the group's timeout breaks the same way, naming the layer and the
shards that did not arrive.  No path carries on with a shard's own
statistics, or with its own rank's.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.profile import GATE

#: seconds a shard waits at a layer's barrier before the group breaks
BARRIER_TIMEOUT_S = 120.0

_local = threading.local()


class ShardGroupError(RuntimeError):
    """A shard group's barrier broke: a timeout, or another shard's
    error."""


class RankShards:
    """This process's data shards among every process's: ``index`` holds
    the global shard index of each local shard (in local shard order),
    ``size`` the number of shards over every rank of the default process
    group.

    ``peers`` (``multihost.Subgroup``) are the data peers the moments
    and a split leaf's slice gradients reduce over: every rank unless a
    ``model`` group spans ranks.  ``every`` is every rank (the default
    group), over which the step sums the replicated leaves' gradients and
    the loss, ``mates`` the ranks of each data shard's model group (1
    unless a group spans ranks), by which it divides that sum.
    ``owners`` lists the ranks of each global shard's model group;
    ``models`` holds, for each local shard, its model group across ranks
    (``sharded.ModelGroup``) or None where the group lies in this rank.

    Host seconds, summed over the threads that spent them:
    ``exchange_s`` in the exchanges' all-reduces, forward and backward;
    ``gather_s`` in the split layers' cross-rank gathers; ``input_s`` in
    their input-gradient reductions."""

    def __init__(self, index: Sequence[int], size: int, peers=None,
                 owners: Optional[Sequence[Sequence[int]]] = None,
                 models: Optional[Sequence] = None):
        from .multihost import Subgroup, process_info

        self.index = [int(i) for i in index]
        self.size = int(size)
        self.rank, self.world = process_info()
        self.every = Subgroup(range(self.world))
        self.peers = peers if peers is not None else self.every
        self.owners = [tuple(o) for o in owners] if owners is not None \
            else None
        self.mates = len(self.owners[0]) if self.owners else 1
        self.models = list(models) if models is not None \
            else [None] * len(self.index)
        self.exchange_s = 0.0
        self.gather_s = 0.0
        self.input_s = 0.0
        self._lock = threading.Lock()

    def all_reduce(self, t: torch.Tensor) -> None:
        """SUM ``t`` in place over the data peers (the caller's backend:
        gloo or NCCL, whichever the group was formed with)."""
        self.peers.all_reduce(t)

    def add(self, kind: str, seconds: float) -> None:
        """Add ``seconds`` to ``<kind>_s`` (any thread)."""
        with self._lock:
            setattr(self, kind + "_s", getattr(self, kind + "_s") + seconds)

    def exchange(self, local: torch.Tensor) -> torch.Tensor:
        """``(S_global, W)`` of every data shard's rows from this rank's
        ``(S_local, W)`` (:class:`RankExchange`), timed into
        ``exchange_s``."""
        return RankExchange.apply(local, self)


class RankExchange(torch.autograd.Function):
    """Every rank's shard rows from each rank's own.

    forward: one ``all_reduce(SUM)`` over the data peers of a zero-filled
    ``(S_global, W)`` buffer in which this rank fills its shards' rows;
    backward: one ``all_reduce(SUM)`` of the gradient buffer over the same
    peers, of which this rank keeps its own rows (the sum over the peers'
    losses: each data shard's once)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, ranks: RankShards):
        ctx.ranks = ranks
        buf = local.new_zeros((ranks.size, local.shape[1]))
        buf[ranks.index] = local
        t0 = time.perf_counter()
        ranks.all_reduce(buf)
        ranks.exchange_s += time.perf_counter() - t0
        return buf

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ranks = ctx.ranks
        g = grad.clone(memory_format=torch.contiguous_format)
        t0 = time.perf_counter()
        ranks.all_reduce(g)
        ranks.exchange_s += time.perf_counter() - t0
        return g[ranks.index], None


class ShardGroup:
    """The data shards of one training step: ``size`` slots, one barrier,
    and each shard's thread entering through :meth:`shard`; with
    ``ranks`` (:class:`RankShards`) the shards of this process among
    every process's.

    Posts alternate between two slot rows by layer parity: a shard posts
    layer L+1 only after every shard has passed layer L's barrier, and
    each shard reads layer L's row right after that barrier, before it
    posts again.  Across ranks the lead's exchanged buffer alternates the
    same way, read after the second barrier."""

    def __init__(self, size: int, timeout: float = BARRIER_TIMEOUT_S,
                 ranks: Optional[RankShards] = None):
        self.size = int(size)
        self.timeout = float(timeout)
        self.ranks = ranks
        if ranks is not None and len(ranks.index) != self.size:
            raise ValueError(f"sync batch norm: {self.size} shards, "
                             f"{len(ranks.index)} global shard indices")
        self._barrier = threading.Barrier(self.size)
        self._rows: Tuple[List, List] = ([None] * self.size,
                                         [None] * self.size)
        self._swapped: List[Optional[Tuple]] = [None, None]
        self._posted = [-1] * self.size      # each shard's last layer
        self._joins: Tuple[List, List] = ([None] * self.size,
                                          [None] * self.size)
        self._joined: List[Optional[Sequence]] = [None, None]
        self._joined_at = [-1] * self.size   # each shard's last join
        self._weights: Dict[Tuple, torch.Tensor] = {}
        self._lock = threading.Lock()
        #: (shard, exception) of the first shard that raised
        self.error: Optional[Tuple[int, BaseException]] = None
        #: host seconds each shard waited at the barriers
        self.wait_s = [0.0] * self.size

    @contextmanager
    def shard(self, index: int):
        """Run the calling thread as shard ``index``: :func:`batch_moments`
        combines over the group, :func:`joined` joins it.  An exception
        inside aborts the group."""
        prev = getattr(_local, "cur", None)
        _local.cur = [self, int(index), 0, 0]
        try:
            yield
        except BaseException as e:
            self.fail(index, e)
            raise
        finally:
            _local.cur = prev

    def fail(self, index: int, exc: BaseException) -> None:
        """Record ``exc`` (the first one kept) and break the barrier."""
        with self._lock:
            if self.error is None:
                self.error = (int(index), exc)
        self._barrier.abort()

    def _weights_on(self, device: torch.device, ns: Sequence[int]
                    ) -> torch.Tensor:
        """(S, 1) f32 ``n_k / N`` on ``device``: one small copy a step and
        device (the fractions repeat from layer to layer), from pinned
        memory to a card, so the host never waits for it."""
        total = sum(ns)
        key = (device, tuple(n / total for n in ns))
        w = self._weights.get(key)
        if w is None:
            w = torch.tensor([[f] for f in key[1]], dtype=torch.float32)
            if device.type == "cuda":
                w = w.pin_memory().to(device, non_blocking=True)
            else:
                w = w.to(device)
            self._weights[key] = w    # a race only makes it twice
        return w

    def _broken(self, index: int, layer: int, exchanged: bool = False,
                join: bool = False) -> ShardGroupError:
        where = f"join {layer}" if join else f"layer {layer}"
        err = self.error
        if err is not None and err[0] != index:
            return ShardGroupError(
                f"sync batch norm: {where}: shard {err[0]} raised "
                f"{type(err[1]).__name__}: {err[1]}")
        if exchanged:
            return ShardGroupError(
                f"sync batch norm: {where}: the "
                f"{'lead' if join else 'exchange across ranks'} did not "
                f"finish within {self.timeout:g} s")
        posted = self._joined_at if join else self._posted
        late = [j for j, p in enumerate(posted) if p < layer]
        return ShardGroupError(
            f"sync batch norm: {where}: shards {late} of "
            f"{self.size} did not arrive within {self.timeout:g} s")

    def _wait(self, index: int, layer: int, exchanged: bool = False,
              join: bool = False) -> None:
        t0 = time.perf_counter()
        try:
            with GATE.outside():      # a wait, not a torch op
                self._barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            raise self._broken(index, layer, exchanged, join) from None
        self.wait_s[index] += time.perf_counter() - t0

    def join(self, index: int, call: int, x, fn: Callable[[List], Sequence]):
        """``fn`` applied by the lead (shard 0) to every shard's ``x`` of
        this call, between two barriers; shard ``index``'s item of what it
        returned.  Posts alternate between two rows by call parity, as the
        moments do by layer parity."""
        row = self._joins[call % 2]
        row[index] = x
        self._joined_at[index] = call
        self._wait(index, call, join=True)
        if index == 0:
            self._joined[call % 2] = fn(list(row))
        self._wait(index, call, exchanged=True, join=True)
        return self._joined[call % 2][index]

    def moments(self, index: int, layer: int, y32: torch.Tensor,
                dims: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        n = math.prod(y32.shape[d] for d in dims)
        mean, var = y32.mean(dim=dims), y32.var(dim=dims, unbiased=False)
        ready = None
        if mean.is_cuda:    # behind the kernels of this shard's stream
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(mean.device))
        row = self._rows[layer % 2]
        row[index] = (n, mean, var, ready)
        self._posted[index] = layer
        self._wait(index, layer)
        dev = mean.device
        if self.ranks is None:
            ns = [p[0] for p in row]
            m = torch.stack([_fetch(p[1], p[3], dev) for p in row])
            v = torch.stack([_fetch(p[2], p[3], dev) for p in row])
        else:
            if index == 0:
                self._swapped[layer % 2] = self._exchange(row, dev)
            self._wait(index, layer, exchanged=True)
            got, ready = self._swapped[layer % 2]
            r = _fetch(got, ready, dev)
            c = r.shape[1] // 2
            m, v = r[:, :c].contiguous(), r[:, c:].contiguous()
            # every shard holds b/S_global rows of one row shape (the
            # step checks it across ranks before its forward)
            ns = [n] * self.ranks.size
        w = self._weights_on(dev, ns)
        mu = (w * m).sum(0)
        return mu, (w * (v + (m - mu) ** 2)).sum(0)

    def _exchange(self, row, dev: torch.device):
        """The lead's cross-rank exchange of one layer: this rank's
        ``(mean_k, var_k)`` rows gathered on the lead's device, every
        rank's after the all-reduce, and an event behind it where it lies
        on a card."""
        m = torch.stack([_fetch(p[1], p[3], dev) for p in row])
        v = torch.stack([_fetch(p[2], p[3], dev) for p in row])
        got = self.ranks.exchange(torch.cat([m, v], 1))
        ready = None
        if got.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(got.device))
        return got, ready


def _fetch(t: torch.Tensor, ready, dev: torch.device) -> torch.Tensor:
    """``t``, posted by another shard, on ``dev``: the calling thread's
    current stream on ``t``'s card waits for the poster's event first (a
    host tensor needs none)."""
    if ready is not None:
        stream = torch.cuda.current_stream(t.device)
        stream.wait_event(ready)
        t.record_stream(stream)
    return t.to(dev)


def joined(x, fn: Callable[[List], Sequence]):
    """``fn(xs)``'s item for the calling shard, ``fn`` applied once to
    every shard's ``x`` of the calling thread's group
    (:meth:`ShardGroup.join`); ``fn([x])[0]`` when no group is active.
    Every shard of a group joins at the same calls in the same order."""
    cur = getattr(_local, "cur", None)
    if cur is None:
        return fn([x])[0]
    group, index, _, call = cur
    cur[3] = call + 1
    return group.join(index, call, x, fn)


def batch_moments(y32: torch.Tensor, dims: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean, var)`` over ``dims`` of ``y32``, the variance the
    population's: of these rows alone when no group is active, else of
    every shard's rows of the calling thread's group (one barrier)."""
    cur = getattr(_local, "cur", None)
    if cur is None:
        return y32.mean(dim=dims), y32.var(dim=dims, unbiased=False)
    group, index, layer, _ = cur
    cur[2] = layer + 1
    return group.moments(index, layer, y32, dims)
