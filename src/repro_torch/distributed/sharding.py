"""Logical-axis sharding rules, without a mesh (the port's copy of the
reference's `distributed/sharding.py`, its mesh-free half).

Models never mention mesh axes directly; they use logical names, and the
rules map logical -> mesh axes per sharding mode. Anything the mesh does not
provide is dropped, so with no mesh every name resolves to None (replicated)
and `constrain` returns its input: the models, the serving engine and the
preprocessing plans call it the same way with or without one.

Modes
  tp       : batch over (pod,data); fused feature dims (q_dim/kv_dim/ff/vocab/
             experts) over model; weights' d_model replicated.
  fsdp_tp  : tp + weights/optimizer d_model ("embed") dim sharded over data.
  zero3    : pure data parallelism, weights sharded on their feature dims.
  sp_ep    : sequence-parallel residual stream, expert-parallel MoE.

A mesh (a torch `DeviceMesh`, constraints as DTensor redistributions) is
ROADMAP Queue A item 1's mesh half; until it is ported a non-None mesh
raises `NotImplementedError`.
"""
from __future__ import annotations

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


class ShardingRules:
    def __init__(self, mesh=None, mode: str = "tp",
                 overrides: dict | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "ShardingRules over a mesh (a torch DeviceMesh with DTensor "
                "placements) is not ported yet: ROADMAP Queue A item 1")
        if mode not in _TABLES:
            raise KeyError(f"unknown sharding mode {mode!r}")
        self.mesh = None
        self.mode = mode
        table = dict(_TABLES[mode])
        if overrides:
            table.update(overrides)
        self._table = table

    def _resolve(self, name):
        """The mesh axes of one logical name: None (replicated) without a
        mesh. An unknown name raises KeyError, as in the reference."""
        if name is not None:
            self._table[name]
        return None

    def spec(self, *axes) -> tuple:
        """Mesh axes per dim from logical axis names (None = replicated)."""
        return tuple(self._resolve(a) for a in axes)

    def sharding(self, *axes):
        """The placement of a tensor with these logical axes: None without
        a mesh."""
        self.spec(*axes)
        return None

    def constrain(self, x, *axes):
        """A no-op without a mesh: returns `x` itself."""
        return x

    @property
    def fingerprint(self):
        """Stable hashable identity: mode, mesh (none) and the resolved rule
        table, equal to the reference's for the same mode and overrides."""
        table = tuple(sorted((k, tuple(v)) for k, v in self._table.items()))
        return (self.mode, (), table)


NULL_RULES = ShardingRules(mesh=None)


def pool_rules(n_shards, meshes=None, mode="tp", overrides=None):
    """Per-shard ShardingRules for a ShardedPlan: `meshes` is None (one
    unmeshed rules object a shard) or, once the mesh half is ported, a mesh
    or a sequence of per-shard meshes (cycled if shorter than n_shards)."""
    if meshes is None or not isinstance(meshes, (list, tuple)):
        meshes = [meshes]
    meshes = list(meshes)
    return [ShardingRules(meshes[j % len(meshes)], mode=mode,
                          overrides=overrides) for j in range(n_shards)]
