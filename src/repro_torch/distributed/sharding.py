"""Logical-axis sharding rules (the port's copy of the reference's
`distributed/sharding.py`) over a torch `DeviceMesh`.

Models never mention mesh axes directly; they use logical names, and the
rules map logical -> mesh axes per sharding mode. Anything the mesh does not
provide is dropped (its `mesh_dim_names` filter each name's axes), so with
no mesh every name resolves to None (replicated) and `constrain` returns its
input: the models, the serving engine and the preprocessing plans call it
the same way with or without one.

Under a mesh, `spec` gives the reference's `PartitionSpec` entries as a
tuple, `sharding` the DTensor placements (one per mesh dim: `Shard(d)` where
the spec puts tensor dim d on that mesh axis, else `Replicate()`), and
`constrain` redistributes a DTensor to them.

Modes
  tp       : batch over (pod,data); fused feature dims (q_dim/kv_dim/ff/vocab/
             experts) over model; weights' d_model replicated.
  fsdp_tp  : tp + weights/optimizer d_model ("embed") dim sharded over data.
  zero3    : pure data parallelism, weights sharded on their feature dims.
  sp_ep    : sequence-parallel residual stream, expert-parallel MoE.
"""
from __future__ import annotations

import torch

# logical axis -> preferred mesh axes (filtered by what the mesh provides);
# the four tables equal the reference's, entry for entry
_TABLES = {
    "tp": {
        "batch": ("pod", "data"),
        "seq": (),
        "embed": (),            # residual d_model: replicated
        "q_dim": ("model",),    # fused num_heads*head_dim
        "kv_dim": ("model",),
        "heads": ("model",),    # only used where head count divides
        "kv_heads": (),
        "ff": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_ff": (),
        # activation-side axes (distinct from the weight-side names so modes
        # like zero3 can shard batch over "model" without duplicate specs)
        "act_q": ("model",),
        "act_kv": ("model",),
        "act_ff": ("model",),
        "act_vocab": ("model",),
        "act_experts": ("model",),
        "act_expert_ff": (),
        "kv_seq": (),
        "conv": (),
        "state": (),
        # weight-side d_model (first dim of most projection matrices)
        "w_embed": (),
        # audio pipeline
        "chunks": ("pod", "data", "model"),   # data parallel, every device
        "samples": (),
        "bins": (),
    },
}
_TABLES["fsdp_tp"] = dict(_TABLES["tp"], w_embed=("pod", "data"),
                          expert_ff=())
_TABLES["zero3"] = dict(
    _TABLES["tp"],
    batch=("pod", "data", "model"),
    w_embed=("data",),
    act_q=(), act_kv=(), act_ff=(), act_vocab=(), act_experts=(),
    act_expert_ff=(),
)
_TABLES["sp_ep"] = dict(
    _TABLES["fsdp_tp"],
    seq=("model",), seq_cp=("model",),
    q_dim=(), kv_dim=(), ff=(), vocab=(),
    act_q=(), act_kv=(), act_ff=(), act_vocab=(),
)
for _t in ("tp", "fsdp_tp", "zero3"):
    _TABLES[_t]["seq_cp"] = ()


class Placements(tuple):
    """DTensor placements, one per mesh dim, that also carry their mesh
    (as the reference's `NamedSharding` does): a tuple, equal to the plain
    tuple of the same placements."""

    def __new__(cls, placements, mesh):
        self = super().__new__(cls, placements)
        self.mesh = mesh
        return self

    def __reduce__(self):
        return tuple, (tuple(self),)

    def place(self, t):
        """`t` (a tensor every rank holds whole) as a DTensor with these
        placements: each rank keeps its own block, no communication. A
        DTensor is redistributed."""
        if is_dtensor(t):
            if tuple(t.placements) == tuple(self):
                return t
            return t.redistribute(self.mesh, tuple(self))
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, tuple(self),
                                 src_data_rank=None)


class ShardingRules:
    def __init__(self, mesh=None, mode: str = "tp",
                 overrides: dict | None = None):
        if mode not in _TABLES:
            raise KeyError(f"unknown sharding mode {mode!r}")
        self.mesh = mesh
        self.mode = mode
        table = dict(_TABLES[mode])
        if overrides:
            table.update(overrides)
        self._table = table
        self._mesh_axes = (set(mesh.mesh_dim_names or ())
                           if mesh is not None else set())

    def _resolve(self, name):
        """The mesh axes of one logical name: None (replicated), one axis
        name, or a tuple of them. An unknown name raises KeyError, as in
        the reference."""
        if name is None:
            return None
        axes = tuple(a for a in self._table[name] if a in self._mesh_axes)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, *axes) -> tuple:
        """The reference's PartitionSpec entries from logical axis names
        (None = replicated dim)."""
        return tuple(self._resolve(a) for a in axes)

    def sharding(self, *axes):
        """The DTensor placements of a tensor with these logical axes (one
        per mesh dim); None without a mesh."""
        spec = self.spec(*axes)
        if self.mesh is None:
            return None
        from torch.distributed.tensor import Replicate, Shard
        placements = [Replicate()] * self.mesh.ndim
        names = list(self.mesh.mesh_dim_names)
        for d, entry in enumerate(spec):
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                placements[names.index(ax)] = Shard(d)
        return Placements(placements, self.mesh)

    def constrain(self, x, *axes):
        """A DTensor redistributed to these axes' placements; a plain
        tensor (or any other value) comes back as it is."""
        if self.mesh is None or not is_dtensor(x):
            return x
        placements = tuple(self.sharding(*axes))
        if tuple(x.placements) == placements:
            return x
        # both ways contiguous: a redistributed local block (and the
        # gradient the redistribution hands back) may not be, and ops such
        # as einsum view them
        x = _ContiguousGrad.apply(x)
        return x.redistribute(self.mesh, placements).contiguous()

    @property
    def fingerprint(self):
        """Stable hashable identity: mode, mesh (dim names, shape and the
        flattened rank ids, the reference's device ids, so two same-shape
        meshes over different ranks differ) and the resolved rule table."""
        mesh = (() if self.mesh is None
                else (tuple(self.mesh.mesh_dim_names),
                      tuple(self.mesh.mesh.shape),
                      tuple(int(r) for r in self.mesh.mesh.flatten())))
        table = tuple(sorted((k, tuple(v)) for k, v in self._table.items()))
        return (self.mode, mesh, table)


NULL_RULES = ShardingRules(mesh=None)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(x):
    """A DTensor gathered whole (the same tensor on every rank); anything
    else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def place_like(new, old):
    """`new` placed as `old` is: redistributed to `old`'s DTensor
    placements (a reduction may leave others, a `Partial` sum among them),
    or made whole where `old` is a plain tensor. A plain `new` comes back
    as it is."""
    if not is_dtensor(new):
        return new
    if not is_dtensor(old):
        return new.full_tensor()
    if tuple(new.placements) != tuple(old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def replicate_dim(x, dim):
    """`x` with tensor dim `dim` made whole on every rank: a DTensor sharded
    on it is redistributed to `Replicate()` there (its other placements
    kept); anything else comes back as it is. For ops that index along a
    sharded dim (an embedding lookup, a gather over the vocab)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    placements = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim
                       else pl for pl in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def batch_local(fn, *xs, **kw):
    """`fn(*xs, **kw)` on each rank's batch rows: DTensor arguments keep
    only their batch (dim 0) sharding, every other dim made whole, and run
    as local tensors; the result is the DTensor of the first's placements.
    For an op that is local per batch row but that DTensor cannot place
    on another layout (attention over heads sharded beside the batch).
    Without DTensors, `fn(*xs, **kw)`."""
    if not is_dtensor(xs[0]):
        return fn(*xs, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x0 = xs[0]
    placements = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                       else Replicate() for pl in x0.placements)
    local = [x.redistribute(x0.device_mesh, placements).to_local()
             for x in xs]
    return DTensor.from_local(fn(*local, **kw), x0.device_mesh, placements)


def whole_heads(x, head_dim):
    """`x` (..., heads * head_dim) with its last dim made whole unless
    DTensor shards it in whole heads (a reshape into heads cannot split
    one); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    n = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim in (-1, x.ndim - 1):
            n *= x.device_mesh.size(i)
    if n == 1 or (x.shape[-1] // head_dim) % n == 0:
        return x
    return replicate_dim(x, -1)


def heads_local(fn, q, k, v, **kw):
    """`fn(q, k, v, **kw)` for an attention, q (B,Sq,Hkv,G,D) and k, v
    (B,Skv,Hkv,D), on each rank's batch rows and its block of the heads:
    q's batch sharding is kept and the mesh dims that do not shard the
    batch spread the heads, its KV heads where they divide (k and v with
    them), else its query heads of a group (k and v whole). The result is
    the DTensor of q's placements, so no rank attends a head another rank
    attends. Where neither divides and one mesh dim spreads the heads,
    each rank takes ceil(H / n) query heads (torch.chunk's blocks: the
    last ranks may take none), each with its KV head, and the result is
    gathered whole over that dim. Otherwise `batch_local` (heads whole).
    Without DTensors, `fn(q, k, v, **kw)`."""
    if not is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    batch = [isinstance(pl, Shard) and pl.dim == 0 for pl in q.placements]
    free = [i for i in range(mesh.ndim) if not batch[i] and mesh.size(i) > 1]
    n = 1
    for i in free:
        n *= mesh.size(i)
    Hkv, G = q.shape[2], q.shape[3]
    even = Hkv % n == 0 or G % n == 0
    if n == 1 or not (even or len(free) == 1):
        return batch_local(fn, q, k, v, **kw)

    def placed(head_dim, shard_heads):
        return tuple(Shard(0) if batch[i]
                     else Shard(head_dim) if shard_heads and i in free
                     else Replicate() for i in range(mesh.ndim))

    def local(t, pl):
        # a tensor whole over the dims that spread the heads is used by
        # each rank for its own heads only: its gradient there is a
        # partial sum
        grad = tuple(Partial() if i in free and isinstance(p, Replicate)
                     else p for i, p in enumerate(pl))
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)

    if even:
        q_dim, kv_head = (2, True) if Hkv % n == 0 else (3, False)
        q_pl, kv_pl = placed(q_dim, True), placed(2, kv_head)
        out = fn(local(q, q_pl), local(k, kv_pl), local(v, kv_pl), **kw)
        return DTensor.from_local(out, mesh, q_pl)
    # uneven: this rank's block of the flattened query heads, each with
    # its own KV head (a group of one)
    rows = placed(2, False)
    ql, kl, vl = (local(t, rows) for t in (q, k, v))
    B, Sq, _, _, D = ql.shape
    H = Hkv * G
    per = -(-H // n)
    h0 = min(mesh.get_local_rank(free[0]) * per, H)
    heads = torch.arange(h0, min(h0 + per, H), device=ql.device)
    out = fn(ql.reshape(B, Sq, H, 1, D)[:, :, h0:h0 + heads.numel()],
             kl[:, :, heads // G], vl[:, :, heads // G], **kw)
    shape = (q.shape[0], Sq, H, 1, D)
    stride = (Sq * H * D, H * D, D, D, 1)
    o = DTensor.from_local(out, mesh, placed(2, True), run_check=False,
                           shape=torch.Size(shape), stride=stride)
    return o.redistribute(mesh, rows).reshape(q.shape)


def rows_local(fn, x, *ws):
    """`fn(x, *ws)` for an op that contracts the last dim of `x` with the
    whole of each `ws` (a projection). Where `x` is a DTensor sharded on
    two of its leading dims (the batch and the sequence of sp_ep's
    residual stream) each rank runs `fn` on its rows, the `ws` whole:
    DTensor cannot place the matmul's flatten of two sharded dims on every
    torch version (2.11 refuses it). Otherwise `fn(x, *ws)` as it is."""
    if not is_dtensor(x):
        return fn(x, *ws)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = {pl.dim for pl in x.placements
            if isinstance(pl, Shard) and pl.dim < x.ndim - 1}
    if len(lead) < 2:
        return fn(x, *ws)
    mesh = x.device_mesh
    placements = tuple(pl if isinstance(pl, Shard) and pl.dim < x.ndim - 1
                       else Replicate() for pl in x.placements)
    # each rank's weight gradient comes from its own rows only: a partial
    # sum over the mesh dims that split the rows
    grads = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                  for pl in placements)
    whole_ws = [w.redistribute(mesh, [Replicate()] * mesh.ndim)
                .to_local(grad_placements=grads) for w in ws]
    out = fn(x.redistribute(mesh, placements).to_local(), *whole_ws)
    return DTensor.from_local(out, mesh, placements)


def pool_rules(n_shards, meshes=None, mode="tp", overrides=None):
    """Per-shard ShardingRules for a ShardedPlan. `meshes` is one mesh
    shared by every shard (or None), or a sequence of per-shard meshes,
    cycled if shorter than n_shards. Same-mesh shards' fingerprints are
    equal; shards over disjoint rank sets differ."""
    if meshes is None or not isinstance(meshes, (list, tuple)):
        meshes = [meshes]
    meshes = list(meshes)
    return [ShardingRules(meshes[j % len(meshes)], mode=mode,
                          overrides=overrides) for j in range(n_shards)]


def _is_spec_leaf(v):
    """A spec leaf is a (possibly empty) tuple of logical names/None;
    tuples of tuples (e.g. xLSTM state tuples) recurse instead."""
    return isinstance(v, tuple) and all(
        e is None or isinstance(e, str) for e in v)


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (nested dicts, lists and tuples; None
    is an empty subtree), with the same-structured `rest` trees' leaves as
    further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_shardings(rules: ShardingRules, spec_tree):
    """Map a tree (dicts, lists, tuples) of logical-axis tuples to DTensor
    placements: None without a mesh, as in the reference."""
    if rules.mesh is None:
        return None

    def walk(t):
        if _is_spec_leaf(t):
            return rules.sharding(*t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return type(t)(walk(v) for v in t)

    return walk(spec_tree)
