"""Stream collectives over a mesh: graph-combinator semantics across devices.

Counterpart of the JAX package's ``parallel/collectives.py``, whose
primitives are ``shard_map`` programs over one controller:

- ``merge`` across devices          = :func:`all_gather_merge`
- ``mux`` across devices            = :func:`all_to_all_regroup`
- reduction fan-in                  = :func:`psum_reduce`
- neighbour streaming (ring)        = :func:`ring_shift`, and
  :func:`ring_attention` built on it.

Each returns a callable taking the GLOBAL value (every process passes
the whole array, as a JAX host array is placed with ``device_put``) and
returning the global result on the first device of the axis this
process holds.  ``axis`` names one mesh axis or a tuple of them (blocks
in row-major order over the tuple).  Block *i* of the sharded dimension
lives on the *i*-th device along the axis and everything happens the way
the devices would do it: an axis whose devices are all local moves its
blocks by device-to-device copies; where the axis spans processes the
blocks cross by ``torch.distributed`` point-to-point messages, and a
``dcn`` axis's reduction and gather run as ``all_reduce``/``all_gather``
on the process group (NCCL on the card, gloo on the host).

``ring_attention`` is plain torch ops here, as it is ``jnp`` in the JAX
package: the hand-written ``flash_attention`` returns no running max or
denominator, so it cannot serve as a ring block.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def _names(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class _Axis:
    """The blocks of one (possibly multi-name) mesh axis: their devices,
    owners and this process's share."""

    def __init__(self, mesh, axis):
        from .multihost import process_info

        self.mesh = mesh
        self.names = _names(axis)
        self.rank = process_info()[0]
        names = list(mesh.axis_names)
        shape = mesh.devices.shape
        for n in self.names:
            if n not in names:
                raise ValueError(f"axis {n!r} not in mesh {names}")
        idx = [names.index(n) for n in self.names]
        # the other axes sit at this process's coordinate on the dcn
        # tier (its own devices) and at 0 elsewhere (replicas)
        base = [0] * len(shape)
        mine = [d for d in mesh.devices.flat
                if d.process_index == self.rank]
        if mine:
            pos = np.unravel_index(list(mesh.devices.flat).index(mine[0]),
                                   shape)
            for i, n in enumerate(names):
                if n in mesh.dcn_axes and n not in self.names:
                    base[i] = pos[i]
        self.devices = []
        for coords in itertools.product(*[range(shape[i]) for i in idx]):
            at = list(base)
            for i, c in zip(idx, coords):
                at[i] = c
            self.devices.append(mesh.devices[tuple(at)])
        self.n = len(self.devices)
        self.local = [i for i, d in enumerate(self.devices)
                      if d.process_index == self.rank]
        if not self.local:
            raise ValueError(f"process {self.rank} holds no device of "
                             f"axis {self.names}")
        self.lead = self.devices[self.local[0]].torch_device
        # the dcn tier's reduction and gather go through the process
        # group (a one-process run without one has nothing to exchange)
        from .multihost import backend

        self.dcn = any(n in mesh.dcn_axes for n in self.names) \
            and bool(backend())

    def dev(self, i: int) -> torch.device:
        return self.devices[i].torch_device

    def owner(self, i: int) -> int:
        return self.devices[i].process_index

    def blocks(self, x: torch.Tensor, dim: int) -> Dict[int, torch.Tensor]:
        """This process's blocks of ``x`` along ``dim``, each on its own
        device."""
        if x.shape[dim] % self.n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {self.n} devices of {self.names}")
        k = x.shape[dim] // self.n
        return {i: x.narrow(dim, i * k, k).to(self.dev(i))
                for i in self.local}

    def move(self, sends: List[Tuple[torch.Tensor, int, int]],
             shapes: Dict[int, Tuple[torch.Tensor, int]], tag: int = 0
             ) -> Dict[int, torch.Tensor]:
        """Deliver blocks: ``sends`` is ``(tensor, src_block,
        dst_block)``; a local destination gets a device-to-device copy,
        a remote one a point-to-point message.  ``shapes`` maps each
        local destination whose source is remote to ``(like, src)``;
        ``tag`` tells apart the messages of one exchange round.  Returns
        the local destinations' blocks."""
        out: Dict[int, torch.Tensor] = {}
        ops = []
        for t, src, dst in sends:
            if self.owner(dst) == self.rank:
                out[dst] = t.to(self.dev(dst), copy=True)
            else:
                ops.append(("send", t.contiguous(), self.owner(dst),
                            tag * self.n + dst))
        for dst, (like, src) in shapes.items():
            buf = torch.empty_like(like, device=self.dev(dst))
            out[dst] = buf
            ops.append(("recv", buf, self.owner(src), tag * self.n + dst))
        if ops:
            import torch.distributed as dist

            p2p = [dist.P2POp(dist.isend if kind == "send" else dist.irecv,
                              t, peer, tag=tag)
                   for kind, t, peer, tag in ops]
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        return out

    def gather(self, local: Dict[int, torch.Tensor], dim: int
               ) -> torch.Tensor:
        """The global value from this process's blocks (in block order)
        on the lead device: an ``all_gather`` over the process group when
        the axis holds a dcn axis."""
        mine = torch.cat([local[i].to(self.lead) for i in self.local], dim)
        if not self.dcn:
            return mine
        import torch.distributed as dist

        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine.contiguous())
        return torch.cat(parts, dim)


def all_gather_merge(mesh, axis="data", concat_dim: int = 0) -> Callable:
    """Every device contributes its block; every device sees the merged
    stream (cross-device tensor_merge along ``concat_dim``)."""

    def run(x: torch.Tensor) -> torch.Tensor:
        ax = _Axis(mesh, axis)
        return ax.gather(ax.blocks(x, concat_dim), concat_dim)

    return run


def psum_reduce(mesh, axis="data") -> Callable:
    """Sum-reduce the blocks across the axis; the result is one block's
    shape (the collective behind gradient fan-in and averaging muxes)."""

    def run(x: torch.Tensor) -> torch.Tensor:
        ax = _Axis(mesh, axis)
        blocks = ax.blocks(x, 0)
        acc = blocks[ax.local[0]].to(ax.lead, copy=True)
        for i in ax.local[1:]:
            acc += blocks[i].to(ax.lead)
        if ax.dcn:
            import torch.distributed as dist

            dist.all_reduce(acc)
        return acc

    return run


def ring_shift(mesh, axis="data", shift: int = 1) -> Callable:
    """Each device hands its block to the device ``shift`` places on
    along the ring (the neighbour exchange of ring attention and
    pipelined stage handoff)."""

    def run(x: torch.Tensor) -> torch.Tensor:
        ax = _Axis(mesh, axis)
        blocks = ax.blocks(x, 0)
        out = _rotate(ax, {i: [b] for i, b in blocks.items()}, shift)
        return ax.gather({i: t[0] for i, t in out.items()}, 0)

    return run


def _rotate(ax: _Axis, held: Dict[int, List[torch.Tensor]], shift: int
            ) -> Dict[int, List[torch.Tensor]]:
    """Every local block list moves ``shift`` places along the ring."""
    out: Dict[int, List[torch.Tensor]] = {}
    width = len(next(iter(held.values())))
    for j in range(width):
        sends = [(ts[j], i, (i + shift) % ax.n) for i, ts in held.items()]
        shapes = {}
        for dst in ax.local:
            src = (dst - shift) % ax.n
            if ax.owner(src) != ax.rank:
                shapes[dst] = (held[ax.local[0]][j], src)
        moved = ax.move(sends, shapes, tag=j)
        for dst, t in moved.items():
            out.setdefault(dst, []).append(t)
    return out


def all_to_all_regroup(mesh, axis="data", split_dim: int = 1,
                       concat_dim: int = 0) -> Callable:
    """Change which dimension is sharded: blocks along ``concat_dim`` in,
    blocks along ``split_dim`` out (cross-device tensor_mux regrouping;
    the sequence/head exchange of all-to-all sequence parallelism).  The
    global value is unchanged; only where its pieces live moves."""

    def run(x: torch.Tensor) -> torch.Tensor:
        ax = _Axis(mesh, axis)
        blocks = ax.blocks(x, concat_dim)
        pieces = {i: b.chunk(ax.n, split_dim) for i, b in blocks.items()}
        got: Dict[int, Dict[int, torch.Tensor]] = {}
        for src in range(ax.n):
            sends = [(pieces[src][dst], src, dst) for dst in range(ax.n)] \
                if src in pieces else []
            shapes = {}
            if ax.owner(src) != ax.rank:
                like = next(iter(pieces.values()))[0]
                shapes = {dst: (like, src) for dst in ax.local}
            for dst, t in ax.move(sends, shapes, tag=src).items():
                got.setdefault(dst, {})[src] = t
        out = {j: torch.cat([got[j][i] for i in range(ax.n)], concat_dim)
               for j in ax.local}
        return ax.gather(out, split_dim)

    return run


def ring_attention(mesh, axis="data") -> Callable:
    """Blockwise ring attention over a sequence sharded across devices.

    Each device holds a (B, S/n, H) block of q/k/v; the k/v blocks rotate
    around the ring while each device accumulates softmax(q·kᵀ)·v online
    (running max and normaliser), so attention over the whole sequence
    never materialises on one device.  ``run(q, k, v)`` -> (B, S, H)."""

    def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
        ax = _Axis(mesh, axis)
        qb, kb, vb = (ax.blocks(t, 1) for t in (q, k, v))
        scale = 1.0 / torch.tensor(math.sqrt(q.shape[-1]),
                                   dtype=torch.float32).to(q.dtype)
        state = {}
        for i in ax.local:
            shp = qb[i].shape[:-1]
            state[i] = [torch.full(shp, -math.inf, dtype=torch.float32,
                                   device=ax.dev(i)),
                        torch.zeros(qb[i].shape, dtype=torch.float32,
                                    device=ax.dev(i)),
                        torch.zeros(shp, dtype=torch.float32,
                                    device=ax.dev(i))]
        held = {i: [kb[i], vb[i]] for i in ax.local}
        for step in range(ax.n):
            for i in ax.local:
                k_blk, v_blk = held[i]
                m, acc, denom = state[i]
                s = torch.einsum("bqh,bkh->bqk", qb[i], k_blk).float() \
                    * scale.float()
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                acc = acc * corr[..., None] + torch.einsum(
                    "bqk,bkh->bqh", p, v_blk.float())
                denom = denom * corr + p.sum(-1)
                state[i] = [m_new, acc, denom]
            if step + 1 < ax.n:
                held = _rotate(ax, held, 1)
        out = {i: (acc / denom[..., None]).to(q.dtype)
               for i, (_, acc, denom) in state.items()}
        return ax.gather(out, 1)

    return run
