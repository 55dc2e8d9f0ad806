"""The collectives of the sharded forward, over the ranks of one process
and, under autograd, over the processes of a job.

Where XLA inserts a psum or an all-gather between the shards of a GSPMD
program, the port's sharded forward (`models/transformer.sharded_forward`)
calls these on the list of the ranks' partial results, rank order:

- `all_reduce(parts)`: the sum (or the maximum), in rank order, on each
  rank's device;
- `all_gather(parts, dim)`: the concatenation along `dim`, in rank order,
  on each rank's device;
- `all_to_all(parts, split_axis, concat_axis)`: rank r's chunk j goes to
  rank j (`jax.lax.all_to_all`), the expert dispatch of
  `parallel/expert.py`; with a `CommGroup`, over the ranks of every
  process of the group (`CommGroup.all_to_all` under autograd, whose
  backward is the reverse exchange).

When every rank is on one device (tp ranks sharing one card) these are
plain tensor ops, done once and handed to every rank, and autograd
differentiates them as it does any sum or concatenation.  Across local
cards each device gets the parts copied to it and reduces them there
(written, not verified: it needs a host with several cards).

A tensor-parallel group that spans processes (one process per card, or
processes sharing a card) passes a `CommGroup`: the process's ranks are
reduced locally, then across the group's processes through
`torch.distributed`, with the Megatron pair of autograd Functions that
keeps every process's gradients whole.  Each process computes the
replicated values (norms, residuals, the loss) itself, so:

- `reduce_from_ranks` (after a row-parallel product, the embedding's
  vocabulary slices): an all-reduce whose backward is the identity;
- `copy_to_ranks` (at a column-parallel input, the head's input, the
  MoE router's weights before each rank takes its experts' share): the
  identity, whose backward all-reduces what the process's ranks gave
  back;
- `gather_from_ranks` (the head's vocabulary slices, an ep layer's
  combined tokens): an all-gather whose backward keeps the process's own
  slice;
- `gather_summed` (the ring's K/V chunks, which every process's queries
  read): an all-gather whose backward sums the cotangent over the
  group's processes and keeps the process's slice, a reduce-scatter.

A bare `dist.all_reduce` inside the forward would be invisible to
autograd: every tp gradient would come out wrong.  `CommGroup` also
moves whole tensors (`all_reduce_`, `all_reduce_many_`, `all_gather`)
outside autograd: the data-parallel gradient all-reduce, the clip's
norm, the checkpoint's gather, and the pipeline stages' activations and
their gradients (`send`, `recv`: point to point, outside autograd; the
Trainer makes a received activation a leaf and sends its gradient back,
the Megatron schedule).  Under gloo a CUDA tensor travels through a
pinned host buffer (processes sharing one card); under NCCL it stays on
its card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce",
    "all_gather",
    "all_to_all",
    "CommGroup",
    "reduce_from_ranks",
    "copy_to_ranks",
    "gather_from_ranks",
    "gather_summed",
]


def _per_device(parts: Sequence[torch.Tensor], combine) -> List[torch.Tensor]:
    out: Dict[torch.device, torch.Tensor] = {}
    for p in parts:
        if p.device not in out:
            out[p.device] = combine([q.to(p.device, non_blocking=True) for q in parts])
    return [out[p.device] for p in parts]


_OPS = {"sum": torch.add, "max": torch.maximum}
_DIST_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# the bucket of the whole-tensor all-reduce: big enough to amortise a
# call, small enough that its pinned staging buffer stays modest
BUCKET_BYTES = 256 << 20


class CommGroup:
    """The processes `ranks` of the job (global ranks, in group order) as
    this process sees them: its `index` in the group and the group's
    `size`.  Every process of the job must build every group, in one
    order (`torch.distributed.new_group` is collective).  Counts
    `calls`, `bytes` (what this process sent) and `seconds` (host time
    from the call to the result on the tensor's device)."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        me = dist.get_rank()
        self.index = self.ranks.index(me) if me in self.ranks else -1
        whole = self.size == dist.get_world_size()
        self.group = None if whole else dist.new_group(self.ranks)
        self.staged = dist.get_backend() == "gloo"
        self._pinned: Dict[str, torch.Tensor] = {}  # one growing byte buffer per use
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def __repr__(self) -> str:
        return f"CommGroup(ranks={self.ranks}, index={self.index})"

    def _stage(self, x: torch.Tensor, key: str) -> torch.Tensor:
        """`x` where the backend can read it: a pinned host copy under gloo
        for a CUDA tensor, else `x` itself."""
        buf = self._buffer(x, key)
        if buf is not x:
            buf.copy_(x.reshape(-1))
        return buf

    def _buffer(self, x: torch.Tensor, key: str) -> torch.Tensor:
        """The pinned host buffer `_stage` uses for `x` under gloo (flat, not
        filled), else `x` itself."""
        if not (self.staged and x.device.type == "cuda"):
            return x
        n = x.numel() * x.element_size()
        if key not in self._pinned or self._pinned[key].numel() < n:
            self._pinned[key] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self._pinned[key][:n].view(x.dtype)

    def _tick(self, t0: float, x: torch.Tensor) -> None:
        if x.device.type == "cuda":
            torch.cuda.current_stream(x.device).synchronize()
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        self.seconds += time.perf_counter() - t0

    def all_reduce_(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce `x` over the group's processes, in place; returns it."""
        t0 = time.perf_counter()
        buf = self._stage(x, "reduce")
        dist.all_reduce(buf, op=_DIST_OPS[op], group=self.group)
        if buf is not x:
            x.copy_(buf.reshape(x.shape), non_blocking=True)
        self._tick(t0, x)
        return x

    def all_reduce_many_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor of `tensors` (one dtype) over the group, in
        place, in flat buckets of at most `BUCKET_BYTES`."""
        bucket: List[torch.Tensor] = []
        size = 0
        for x in list(tensors) + [None]:
            if x is not None and (not bucket or size + x.numel() * x.element_size()
                                  <= BUCKET_BYTES):
                bucket.append(x)
                size += x.numel() * x.element_size()
                continue
            if bucket:
                flat = torch.cat([b.reshape(-1) for b in bucket])
                self.all_reduce_(flat)
                off = 0
                for b in bucket:
                    b.copy_(flat[off : off + b.numel()].view_as(b))
                    off += b.numel()
            bucket, size = ([x], x.numel() * x.element_size()) if x is not None else ([], 0)

    def send(self, x: torch.Tensor, to: int) -> None:
        """Send `x` to the group's process `to` (a group index): the
        pipeline stage hop.  Blocking under gloo: a peer receives in the
        same order as this process sends."""
        t0 = time.perf_counter()
        dist.send(self._stage(x.detach().contiguous(), "send"), self.ranks[to])
        self._tick(t0, x)

    def recv(self, shape, dtype, device, frm: int) -> torch.Tensor:
        """A tensor of `shape` and `dtype` on `device`, received from the
        group's process `frm` (a group index)."""
        t0 = time.perf_counter()
        out = torch.empty(shape, dtype=dtype, device=device)
        buf = self._buffer(out, "recv")
        dist.recv(buf, self.ranks[frm])
        if buf is not out:
            out.copy_(buf.reshape(out.shape), non_blocking=True)
        self._tick(t0, out)
        return out

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's `x`s joined along `dim` in group order (every
        process's `x` of one shape), on `x`'s device."""
        t0 = time.perf_counter()
        src = self._stage(x.contiguous(), "gather")
        outs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(outs, src, group=self.group)
        parts = [o.reshape(x.shape).to(x.device, non_blocking=True) for o in outs]
        out = torch.cat(parts, dim=dim)
        self._tick(t0, out)
        return out


    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The exchange of `x`'s `size` slices along dim 0: slice q goes to
        the group's process q, and slice q of the result is what process q
        sent here (outside autograd).  Moved as raw bytes, so every dtype
        travels."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all over {self.size} processes: dim 0 of "
                             f"{tuple(x.shape)} must be {self.size}")
        t0 = time.perf_counter()
        x = x.contiguous()
        out = torch.empty_like(x)
        src = self._stage(x, "a2a-send")
        dst = self._buffer(out, "a2a-recv")
        dist.all_to_all_single(dst.reshape(-1).view(torch.uint8),
                               src.reshape(-1).view(torch.uint8), group=self.group)
        if dst is not out:
            out.copy_(dst.reshape(out.shape), non_blocking=True)
        self._tick(t0, out)
        return out


class _ReduceFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: CommGroup):
        return group.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: CommGroup):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone(memory_format=torch.contiguous_format)), None


class _GatherFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group: CommGroup):
        ctx.dim, ctx.index, ctx.n, ctx.group = dim, group.index, x.shape[dim], group
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


class _GatherSummed(_GatherFromRanks):
    @staticmethod
    def backward(ctx, g):
        g = ctx.group.all_reduce_(g.clone(memory_format=torch.contiguous_format))
        return _GatherFromRanks.backward(ctx, g)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: CommGroup):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own reverse: slice q came from process q
        return ctx.group.all_to_all(g), None


def reduce_from_ranks(x: torch.Tensor, group: Optional[CommGroup]) -> torch.Tensor:
    """The sum of `x` over the group's processes; backward: the identity."""
    return x if group is None or group.size == 1 else _ReduceFromRanks.apply(x, group)


def copy_to_ranks(x: torch.Tensor, group: Optional[CommGroup]) -> torch.Tensor:
    """`x`; backward: its gradient summed over the group's processes."""
    return x if group is None or group.size == 1 else _CopyToRanks.apply(x, group)


def gather_from_ranks(x: torch.Tensor, dim: int, group: Optional[CommGroup]) -> torch.Tensor:
    """The group's `x`s joined along `dim`; backward: this process's slice."""
    return x if group is None or group.size == 1 else _GatherFromRanks.apply(x, dim, group)


def gather_summed(x: torch.Tensor, dim: int, group: Optional[CommGroup]) -> torch.Tensor:
    """The group's `x`s joined along `dim`; backward: the cotangent summed
    over the group's processes, this process's slice of it.  For a tensor
    that every process's downstream reads differently (the ring's K/V
    chunks), where `gather_from_ranks` would drop the other processes'
    share of its gradient."""
    return x if group is None or group.size == 1 else _GatherSummed.apply(x, dim, group)


def all_reduce(parts: Sequence[torch.Tensor], op: str = "sum",
               group: Optional[CommGroup] = None) -> List[torch.Tensor]:
    """The ranks' `parts` reduced by `op` ("sum" or "max") in rank order,
    one result per rank on its device (the same tensor for ranks that
    share a device); with `group`, then over the group's processes (the
    maximum outside autograd: it only ever scales a quantized product)."""
    fn = _OPS[op]

    def reduce(ps):
        total = ps[0]
        for p in ps[1:]:
            total = fn(total, p)
        if group is None or group.size == 1:
            return total
        if op == "max":
            return group.all_reduce_(total.detach().clone(), op="max")
        return reduce_from_ranks(total, group)

    return _per_device(parts, reduce)


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               group: Optional[CommGroup] = None) -> List[torch.Tensor]:
    """The ranks' `parts` joined along `dim` in rank order, one result per
    rank on its device; with `group`, then over the group's processes."""
    return _per_device(
        parts, lambda ps: gather_from_ranks(torch.cat(list(ps), dim=dim), dim, group))


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int = 0,
               concat_axis: int = 0, group: Optional[CommGroup] = None) -> List[torch.Tensor]:
    """`jax.lax.all_to_all` over the ranks: each rank's part is cut into P
    equal chunks along `split_axis`, and rank j gets chunk j of every rank,
    joined along `concat_axis` in rank order, on its device.  Index
    arithmetic on the tensors, as the ring's rotation
    (`ops/ring_attention.py`): ranks that share a device exchange views
    of each other's parts, joined once, with no host round trip.
    Autograd differentiates it as the slices and the join it is, so the
    backward is the reverse exchange.

    With `group`, `parts` are this process's ranks (one device), the
    group's processes holding P = len(parts) * group.size ranks in rank
    order: the chunks bound for each process travel in one
    `CommGroup.all_to_all` under autograd (its backward the reverse
    exchange); the result equals the one-process exchange of every
    rank's part."""
    if group is None or group.size == 1:
        P = len(parts)
        _check_split(parts, split_axis, P)
        chunks = [p.chunk(P, dim=split_axis) for p in parts]
        return [torch.cat([c[j].to(parts[j].device, non_blocking=True) for c in chunks],
                          dim=concat_axis) for j in range(P)]
    n, Q = len(parts), group.size
    P = n * Q
    _check_split(parts, split_axis, P)
    chunks = [p.chunk(P, dim=split_axis) for p in parts]
    # (process q, its local rank j, this process's rank i): chunk q * n + j of rank i
    send = torch.stack([torch.stack([torch.stack([chunks[i][q * n + j] for i in range(n)])
                                     for j in range(n)]) for q in range(Q)])
    got = _AllToAll.apply(send, group)  # (source process q, local rank j, its rank i)
    return [torch.cat([got[q, j, i] for q in range(Q) for i in range(n)], dim=concat_axis)
            for j in range(n)]


def _check_split(parts, split_axis: int, P: int) -> None:
    if any(p.shape[split_axis] % P for p in parts):
        raise ValueError(f"all_to_all over {P} ranks: split axis {split_axis} of "
                         f"{[tuple(p.shape) for p in parts]} does not divide by {P}")
