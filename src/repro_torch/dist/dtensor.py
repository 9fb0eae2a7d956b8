"""The model's side of the mesh: what its layers need to run on DTensors.

Plain ops are left to DTensor's sharding propagation. Four things are not:

- **Mixed operands.** The model builds positions, masks and indices as
  plain tensors; `mixed` runs a call on DTensor parameters under
  ``implicit_replication``, so such a tensor takes part as replicated.
- **The hand-written kernels** take raw pointers, so a kernel wrapper is
  handed local tensors only (it raises on a DTensor). `Layout` lays the
  operands of a kernel out for `local_map`: the batch sharded on the batch
  mesh dims, heads on one mesh dim, everything a rank needs local; each
  rank then runs the kernel (or the plain path) on its own rows and heads.
- **An embedding split on its vocab dim** (`vocab_lookup`): each rank
  looks up its own rows, which a tied head's gradient can meet.
- **Op counts on meta.** A dispatch mode sees a DTensor op at its global
  shapes and not the local ops inside. A kernel's call under a count of
  `roofline.op_stats` is counted the same way, once at its global shapes
  (`kernel_map`): inside the same ``local_map`` as the real call, each
  rank's call runs the wrapper (or plain path) on plain meta tensors of
  the global shapes, forward and backward, and its outputs are empty.
  Counts of DTensor calls are taken on meta tensors only (the dry-run); a
  count of a DTensor call with data raises.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

from repro_torch.roofline import op_stats


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def on_mesh(tree) -> bool:
    """Whether a tree of dicts (parameters) holds DTensors (its first leaf)."""
    return is_dtensor(_first_leaf(tree))


def mixed(tree):
    """``implicit_replication`` when ``tree`` holds DTensors (plain tensors
    then take part in their ops as replicated), else no context. Nested
    calls enter it once: its exit clears the flag rather than restoring
    it, which would end an outer scope's (a training step's backward,
    where remat recomputes the forward)."""
    if not on_mesh(tree) or DTensor._op_dispatcher._allow_implicit_replication:
        return nullcontext()
    return implicit_replication()


def to_placements(t: Optional[torch.Tensor], mesh, placements: Sequence) -> Optional[DTensor]:
    """``t`` as a DTensor on ``mesh`` with ``placements``: a plain tensor
    (the same on every rank) is taken as replicated and each rank keeps its
    slice, which moves nothing; a DTensor is redistributed."""
    if t is None:
        return None
    placements = tuple(placements)
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(mesh, placements)


def global_offset(t: DTensor) -> Tuple[int, ...]:
    """This rank's offset into ``t``'s global shape."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)[1]


def local_rows(t: Optional[torch.Tensor], like: DTensor) -> Optional[torch.Tensor]:
    """This rank's rows of ``t`` (plain or DTensor, batch first) where
    ``like``'s dim 0 is sharded, as a local tensor."""
    if t is None:
        return None
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in like.placements]
    return to_placements(t, like.device_mesh, pl).to_local()


def split_heads(t: torch.Tensor, shape: Sequence[int], heads_dim: int) -> torch.Tensor:
    """``t.reshape(shape)`` where ``shape`` splits ``t``'s last dim into
    (heads, head_dim) at ``heads_dim``: on a DTensor whose last dim is
    sharded over more ranks than the heads divide into, those mesh dims are
    replicated first (GQA: 8 KV heads on a 16-wide model axis), so the view
    keeps whole heads on every rank. The replication is a collective the
    count sees."""
    if is_dtensor(t):
        last = t.ndim - 1
        heads = shape[heads_dim]
        sizes = t.device_mesh.shape
        pl, n, changed = list(t.placements), 1, False
        for j, p in enumerate(pl):
            if p == Shard(last):
                if heads % (n * sizes[j]):
                    pl[j], changed = Replicate(), True
                else:
                    n *= sizes[j]
        if changed:
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*shape)


# ---------------------------------------------------------------------------
# operands of a kernel laid out for local_map
# ---------------------------------------------------------------------------

class Layout:
    """Which mesh dims split the batch and which one splits the heads, for
    one kernel call: ``batch`` the mesh dims whose extent divides the batch
    (in mesh order), ``head`` the mesh dim (or None) over which the ``hq``
    heads are split; ``kv_whole`` says the ``hkv`` key/value heads do not
    divide over it, so they stay replicated and each rank takes the ones
    its query heads read (`kv_slice`)."""

    def __init__(self, mesh, batch: int, batch_dims: Sequence[int], head_dim: Optional[int],
                 hq: int, hkv: int):
        self.mesh = mesh
        n, self.batch = 1, []
        for j in batch_dims:
            if batch % (n * mesh.shape[j]) == 0:
                n *= mesh.shape[j]
                self.batch.append(j)
        self.head = head_dim if head_dim is not None and hq % mesh.shape[head_dim] == 0 else None
        self.hq, self.hkv = hq, hkv
        self.n_head = 1 if self.head is None else mesh.shape[self.head]
        self.kv_whole = self.head is not None and hkv % self.n_head != 0
        if self.kv_whole:
            hq_loc, g = hq // self.n_head, hq // hkv
            if hq_loc % g and g % hq_loc:
                raise NotImplementedError(
                    f"{hq} query heads over {hkv} KV heads split {self.n_head} ways: a rank's "
                    "query heads do not read whole KV heads")

    def of(self, batch_at: Optional[int], head_at: Optional[int] = None) -> Tuple:
        """Placements of an operand whose batch is dim ``batch_at`` and
        whose heads are dim ``head_at`` (None: not split there)."""
        pl: List = [Replicate()] * self.mesh.ndim
        if batch_at is not None:
            for j in self.batch:
                pl[j] = Shard(batch_at)
        if self.head is not None and head_at is not None:
            pl[self.head] = Shard(head_at)
        return tuple(pl)

    def grad_of(self, batch_at: Optional[int], head_at: Optional[int] = None,
                partial_batch: bool = False, partial_head: bool = False) -> Tuple:
        """Placements of an operand's gradient as a rank holds it: like
        `of`, with a sum over ranks (Partial) on the batch dims for an
        operand every batch shard reads (a parameter) and on the head dim
        for one every head shard reads (replicated K/V, SSM B and C)."""
        pl = list(self.of(batch_at, head_at))
        if partial_batch:
            for j in self.batch:
                pl[j] = Partial()
        if partial_head and self.head is not None:
            pl[self.head] = Partial()
        return tuple(pl)

    def kv_slice(self) -> Optional[Tuple[int, int]]:
        """This rank's KV heads [lo, hi) when they stay replicated."""
        if not self.kv_whole:
            return None
        r = self.mesh.get_local_rank(self.head)
        hq_loc, g = self.hq // self.n_head, self.hq // self.hkv
        lo = r * hq_loc // g
        hi = ((r + 1) * hq_loc - 1) // g + 1
        return lo, hi


def batch_and_head_dims(*operands: Tuple[Optional[torch.Tensor], int, Optional[int]]):
    """(batch mesh dims, head mesh dim) read off DTensor operands given as
    (tensor, batch dim, head dim): a mesh dim on which any operand's batch
    is sharded splits the batch; the first other mesh dim on which any
    operand's heads are sharded splits the heads."""
    mesh = next(t.device_mesh for t, _, _ in operands if is_dtensor(t))
    batch, head = [], None
    for j in range(mesh.ndim):
        if any(is_dtensor(t) and t.placements[j] == Shard(b) for t, b, _ in operands
               if b is not None):
            batch.append(j)
    for j in range(mesh.ndim):
        if j not in batch and any(is_dtensor(t) and h is not None and t.placements[j] == Shard(h)
                                  for t, _, h in operands):
            head = j
            break
    return mesh, batch, head


class _GlobalCount(torch.autograd.Function):
    """One rank's kernel call under an op count (meta tensors): ``fn`` runs
    once on plain meta tensors of the operands' global shapes ``specs``
    ((shape, dtype) each), counted; the outputs are empty meta tensors of
    the local shapes in ``outs`` ((global shape, local shape, dtype) each).
    The backward recomputes ``fn`` uncounted and differentiates it under
    the count, at the global shapes, and hands back empty local
    gradients. It saves its operands as a kernel's backward does, so that
    a remat recomputation runs up to it as it runs up to the kernel."""

    @staticmethod
    def forward(ctx, fn, specs, outs, *ts):
        if not all(t.is_meta for t in ts):
            raise NotImplementedError("op_stats counts a DTensor call on meta tensors only")
        ctx.fn, ctx.specs, ctx.outs = fn, specs, outs
        ctx.save_for_backward(*ts)
        fn(*(torch.empty(s, dtype=d, device="meta") for s, d in specs))
        res = tuple(torch.empty(local, dtype=d, device="meta") for _, local, d in outs)
        return res if len(res) > 1 else res[0]

    @staticmethod
    def backward(ctx, *grads):
        plains = [torch.empty(s, dtype=d, device="meta") for s, d in ctx.specs]
        diff = [t.requires_grad_(True) for t in plains if t.is_floating_point()]
        with op_stats.discarded(), torch.enable_grad():
            out = ctx.fn(*plains)
        out = out if isinstance(out, tuple) else (out,)
        pairs = [(o, torch.empty(shape, dtype=g.dtype, device="meta"))
                 for o, g, (shape, _, _) in zip(out, grads, ctx.outs, strict=True)
                 if g is not None and o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], diff, [g for _, g in pairs],
                                  allow_unused=True) if pairs else [None] * len(diff)
        it = iter(got)
        res: List = []
        for t, local in zip(plains, ctx.saved_tensors, strict=True):
            g = next(it) if t.is_floating_point() else None
            res.append(None if g is None else torch.empty_like(local))
        return (None, None, None, *res)


def kernel_map(local, counted, mesh, ops: Sequence[Optional[DTensor]],
               grads: Sequence[Optional[Tuple]], outs: Sequence[Tuple]):
    """A kernel call on DTensor operands through ``local_map``: ``ops`` (None
    where absent) at their own placements, each one's gradient handed back
    at ``grads[i]`` (None: the operand's placements), ``outs`` the outputs'
    (global shape, dtype, placements). Each rank calls ``local`` on its
    local tensors (None where absent). Under an op count (meta tensors) each
    rank's call is `_GlobalCount` of ``counted``, which takes the global
    operands, so the kernel is counted once at its global shapes. The
    DTensor boundary is ``local_map``'s on both paths, so a count sees the
    redistributions around the call, those of the gradients too."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    present = [i for i, t in enumerate(ops) if t is not None]

    def full(ts):
        out = [None] * len(ops)
        for i, t in zip(present, ts, strict=True):
            out[i] = t
        return out

    if op_stats.ACTIVE is None:
        def body(*ts):
            return local(*full(ts))
    else:
        specs = [(tuple(ops[i].shape), ops[i].dtype) for i in present]
        shapes = [(tuple(s), tuple(compute_local_shape_and_global_offset(tuple(s), mesh, p)[0]), d)
                  for s, d, p in outs]

        def body(*ts):
            return _GlobalCount.apply(lambda *g: counted(*full(g)), specs, shapes, *ts)

    out_pl = [list(p) for _, _, p in outs]
    return local_map(
        body, out_placements=out_pl[0] if len(outs) == 1 else tuple(out_pl),
        in_placements=tuple(tuple(ops[i].placements) for i in present),
        in_grad_placements=tuple(tuple(grads[i] or ops[i].placements) for i in present),
        device_mesh=mesh,
    )(*(ops[i] for i in present))


def vocab_lookup(table: DTensor, ids: torch.Tensor) -> DTensor:
    """Rows ``ids`` of an embedding ``table`` whose vocab dim is split over
    some mesh dims: each rank looks its ids up in its own rows through
    ``local_map`` (ids outside them give zeros), a sum over those mesh dims
    pending (Partial), where the table's gradient is the rank's own rows.
    DTensor's own lookup leaves a masked sum that cannot meet the plain sum
    of a tied head's gradient (gemma2-9b trains with both)."""
    import torch.nn.functional as F

    mesh = table.device_mesh
    ids = to_placements(ids, mesh, [Replicate()] * mesh.ndim) if not is_dtensor(ids) else ids
    nd = ids.ndim + 1
    id_pl, out_pl, grad_pl = [], [], []
    for tp, ip in zip(table.placements, ids.placements, strict=True):
        if tp == Shard(0):
            id_pl.append(Replicate())
            out_pl.append(Partial())
            grad_pl.append(tp)
        elif tp == Shard(1):
            id_pl.append(Replicate())
            out_pl.append(Shard(nd - 1))
            grad_pl.append(tp)
        else:
            batch = ip == Shard(0)
            id_pl.append(Shard(0) if batch else Replicate())
            out_pl.append(Shard(0) if batch else Replicate())
            grad_pl.append(Partial() if batch else Replicate())
    ids = to_placements(ids, mesh, id_pl)
    table = to_placements(table, mesh, [p if p.is_shard() else Replicate()
                                        for p in table.placements])
    lo = global_offset(table)[0]

    def local(t, i):
        rel = i - lo
        hit = (rel >= 0) & (rel < t.shape[0])
        return F.embedding(rel.clamp(0, t.shape[0] - 1), t) * hit[..., None].to(t.dtype)

    return kernel_map(local, lambda t, i: F.embedding(i, t), mesh, [table, ids],
                      [tuple(grad_pl), tuple(id_pl)],
                      [((*ids.shape, table.shape[1]), table.dtype, tuple(out_pl))])
