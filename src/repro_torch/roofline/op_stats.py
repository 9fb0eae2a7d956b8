"""FLOPs and bytes of one call of a port function, counted from its ops (the
port's counterpart of ``repro.roofline.hlo_stats``, which parses compiled
HLO; the port has none).

    stats = count(model.decode, params, tokens, positions, cache)
    stats.flops, stats.bytes_accessed, stats.kernels

The call runs under a `TorchDispatchMode` that sees every ATen op it
dispatches, on tensors on the ``meta`` device (nothing is allocated, so a
full-size model counts on any host), on the CPU or on the card:

- **FLOPs** of the matrix products and convolutions, by
  ``torch.utils.flop_counter``'s formulas (mm, addmm, bmm, baddbmm,
  convolution and the rest of its registry).
- **Bytes**: each op's inputs and outputs, an unfused upper bound (the
  reference's ``bytes_accessed``): no op is fused with the next. As the
  reference does for HLO, views and allocations move nothing; an indexed
  read (gather) counts twice its result plus its smaller operands, not the
  whole table it reads from; an indexed write (scatter) twice its smaller
  operands, not the whole buffer it writes into; a copy or fill does not
  read its destination.
- **The hand-written kernels by their own work.** A ctypes launch is
  invisible to a dispatch mode, so while a count is active each kernel
  wrapper adds its ``work()`` (the operations and bytes its bound counts)
  through `kernel` and runs its own path uncounted: the kernel on the
  card, its plain version on the CPU, and on meta tensors nothing (empty
  outputs of the right shapes). A meta, CPU or CUDA call of the same step
  thus gives the same count (`dense` lays the plain version's outputs out
  as the kernel does).

**Collectives** (DTensor parameters on a mesh): a second mode under the
count sees the collectives each call issues, those DTensor inserts inside
its own dispatch too (it lets DTensor ops through, as
``torch.distributed.tensor.debug.CommDebugMode`` does, and records the
functional collectives they become). Each is recorded by kind, by process
group (`by_mesh_dim` names the mesh dim) and with its bytes on the wire
per rank (`wire_bytes`, the reference's ring model), which sum to
``collective_bytes``. A DTensor op itself is counted once at its global
shapes (the dispatch mode sees it before DTensor splits it into local
ops), and a kernel under ``local_map`` once at its global shapes
(`repro_torch.dist.dtensor.kernel_map`): FLOPs and bytes are global.

A kernel's work that depends on index data (which rows a query sees, how
long each cache lane is) reads that data on the CPU or the card; on meta
tensors, which hold none, it takes the canonical layout: every lane's
kv_len the cache's length and the query chunk at its end. That is what a
whole prefill, a training step, a chunk that ends its cache and a decode
at the cache's last row have, so those count the same on every device.

When no count is active, a wrapper's cost is one test of `ACTIVE`.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that allocate or relabel storage and move no data (views are found
# from their schema, `OpOverload.is_view`)
_NO_TRAFFIC = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._unsafe_view, aten.set_, aten.resize_, aten._local_scalar_dense,
}
# indexed reads: the result and the indices, not the table (the reference's
# gather / dynamic-slice)
_GATHER = {aten.index, aten.index_select, aten.embedding, aten.gather}
# indexed writes into a buffer the result aliases: the update and the
# indices, read and written, not the buffer (dynamic-update-slice / scatter)
_SCATTER = {
    aten.index_put, aten.index_put_, aten._index_put_impl_, aten.index_copy, aten.index_copy_,
    aten.index_add, aten.index_add_, aten.scatter, aten.scatter_, aten.scatter_add,
    aten.scatter_add_, aten.slice_scatter, aten.select_scatter,
}
# writes that do not read their destination (the first argument)
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_, aten.uniform_}


@dataclass
class OpStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    ops: int = 0  # ATen ops that moved bytes or did FLOPs (the kernels not among them)
    # kernel name -> [calls, operations, bytes] of the hand-written kernels
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    # (kind, process group name, group size) -> [calls, result bytes, wire bytes per rank]
    collectives: Dict[Tuple[str, str, int], List[float]] = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        """Bytes on the wire per rank of every collective of the call."""
        return sum(c[2] for c in self.collectives.values())

    @property
    def collective_count(self) -> int:
        return int(sum(c[0] for c in self.collectives.values()))


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Per-device bytes moved over the links for one collective (ring
    algorithms), the reference's ``_wire_bytes`` (``repro/roofline/
    analysis.py``) as it is.

    all-reduce: result is the reduced shard-size tensor -> 2*S*(g-1)/g
    all-gather: result is the gathered tensor              -> S*(g-1)/g
    reduce-scatter: result is the scattered piece S/g      -> S*(g-1) (= full*(g-1)/g)
    all-to-all / collective-permute: result-sized exchange -> S*(g-1)/g / S
    """
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * f
    if kind == "all-gather":
        return result_bytes * f
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * f
    return float(result_bytes)  # collective-permute


def by_mesh_dim(stats: OpStats, mesh) -> Dict[str, Dict[str, List[float]]]:
    """{mesh dim name (or the group's name): {kind: [calls, wire bytes]}}."""
    names = {}
    for i, dim in enumerate(mesh.mesh_dim_names or range(mesh.ndim)):
        names[mesh.get_group(i).group_name] = str(dim)
    out: Dict[str, Dict[str, List[float]]] = {}
    for (kind, group, _), (calls, _, wire) in stats.collectives.items():
        row = out.setdefault(names.get(group, group), {}).setdefault(kind, [0, 0.0])
        row[0] += calls
        row[1] += wire
    return out


def _tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one ATen op moves, counted as the module docstring says."""
    packet = func.overloadpacket
    if func.is_view or packet in _NO_TRAFFIC:
        return 0
    ins = _tensors(args[1:] if packet in _WRITE_ONLY else args, [])
    opb = [_nbytes(t) for t in _tensors(kwargs, ins)]
    rb = sum(_nbytes(t) for t in _tensors(out, []))
    if packet in _SCATTER:
        return 2 * sum(b for b in opb if b != rb)
    if packet in _GATHER:
        return 2 * rb + sum(b for b in opb if b < rb)
    return rb + sum(opb)


# the functional collectives DTensor and `redistribute` issue, by the
# reference's kind names (``parse_collective_bytes``)
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd", "c10d")


def _group_of(args) -> Tuple[str, int]:
    """(name, size) of the process group a functional collective names."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = next(a for a in reversed(args) if isinstance(a, str)
                 or type(a).__name__ == "ProcessGroup")
    pg = _resolve_process_group(group) if isinstance(group, str) else group
    return pg.group_name, pg.size()


class _Comms(TorchDispatchMode):
    """Records the collectives of a call. A DTensor op is let through
    (NotImplemented) so that DTensor runs it and the collectives it becomes
    come back here as plain-tensor ops."""

    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(func, "namespace", "") in _COLLECTIVE_NS:
            kind = _COLLECTIVE_KIND.get(func.overloadpacket.__name__)
            if kind is not None:
                name, g = _group_of(args)
                rb = sum(_nbytes(t) for t in _tensors(out, []))
                row = self.stats.collectives.setdefault((kind, name, g), [0, 0.0, 0.0])
                row[0] += 1
                row[1] += rb
                row[2] += wire_bytes(kind, rb, g)
        return out


class _Count(TorchDispatchMode):
    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats
        self.paused = 0
        self.scale = 1  # `scaled`: ops on one rank's shard, counted for every distinct shard

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused and getattr(func, "namespace", "") not in _COLLECTIVE_NS:
            st = self.stats
            flop = flop_registry.get(func.overloadpacket)
            flops = 0 if flop is None else flop(*args, **kwargs, out_val=out)
            nbytes = op_bytes(func, args, kwargs, out)
            if flops or nbytes:
                st.ops += 1
                st.flops += self.scale * flops
                st.bytes_accessed += self.scale * nbytes
        return out


ACTIVE: Optional[_Count] = None  # the count in progress, None when none is


@contextmanager
def counting() -> Iterator[OpStats]:
    """Count every op dispatched inside the block (one count at a time)."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("op_stats: a count is already active")
    stats = OpStats()
    mode = _Count(stats)
    ACTIVE = mode
    try:
        # no process group, no collective: the mode stays out of plain counts
        comms = _Comms(stats) if torch.distributed.is_initialized() else nullcontext()
        with comms, mode:
            yield stats
    finally:
        ACTIVE = None


def count(fn: Callable, *args, **kwargs) -> OpStats:
    """The FLOPs and bytes of one call ``fn(*args, **kwargs)``."""
    with counting() as stats:
        fn(*args, **kwargs)
    return stats


@contextmanager
def scaled(n: int) -> Iterator[None]:
    """Inside a count: ops on one rank's shard of DTensors (a local update
    of every leaf, as the optimizer's) counted ``n`` times, once for each
    distinct shard, so the count stays global; a dim the mesh replicates is
    computed on every rank but counted once. No-op outside a count."""
    mode = ACTIVE
    if mode is None:
        yield
        return
    kept, mode.scale = mode.scale, mode.scale * n
    try:
        yield
    finally:
        mode.scale = kept


@contextmanager
def discarded() -> Iterator[None]:
    """Inside a count: run the block counted into a scratch count that is
    thrown away (a recomputation that is not part of the call), with the
    wrappers taking their counted path (on meta tensors, empty outputs)."""
    mode = ACTIVE
    if mode is None:
        yield
        return
    kept, mode.stats = mode.stats, OpStats()
    kept_coll, kept.collectives = kept.collectives, {}
    try:
        yield
    finally:
        mode.stats = kept
        kept.collectives = kept_coll


def dense(out):
    """A wrapper's outputs laid out as its kernel writes them, contiguous:
    the plain version's may be strided, and an op after it would then copy
    on the CPU where it takes a view on the card. For use inside `kernel`,
    where the copy is not counted."""
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    if isinstance(out, tuple):
        return tuple(dense(t) for t in out)
    return out


@contextmanager
def kernel(name: str, work: Callable[[], Tuple[float, float]]) -> Iterator[None]:
    """For a kernel wrapper while a count is active: add ``work()``, the
    kernel's (operations, bytes), under ``name``, then run the block (the
    wrapper's own path) with nothing counted and `ACTIVE` cleared, so the
    wrapper called again inside takes the path it takes outside a count."""
    global ACTIVE
    mode = ACTIVE
    ACTIVE = None
    mode.paused += 1
    try:
        flops, nbytes = work()
        st = mode.stats
        calls = st.kernels.setdefault(name, [0, 0.0, 0.0])
        calls[0] += 1
        calls[1] += flops
        calls[2] += nbytes
        st.flops += flops
        st.bytes_accessed += nbytes
        yield
    finally:
        mode.paused -= 1
        ACTIVE = mode
