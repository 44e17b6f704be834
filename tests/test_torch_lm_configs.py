"""The port's language-model configs and sharding rules against the JAX
package's: every arch's fields, parameter counts, padded vocab and reduced
config, the shape cells, the four sharding mode tables, the ports of the
reference's no-mesh rules tests, and the rules over a mesh resolving (the
mesh cases against the reference are in test_torch_mesh.py)."""
import dataclasses
import importlib

import pytest
import torch

from repro import configs as RC
from repro.distributed import sharding as RS
from repro_torch import configs as C
from repro_torch.distributed import sharding as S

ARCH_MODULES = ["arctic_480b", "gemma_7b", "granite_moe_3b_a800m",
                "llama3_2_3b", "minitron_8b", "nemotron_4_15b",
                "paligemma_3b", "whisper_small", "xlstm_125m",
                "zamba2_1_2b"]


@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_arch_config_equals_reference(arch):
    got, want = C.ARCHS[arch], RC.ARCHS[arch]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_counts() == want.param_counts()
    for prop in ("q_dim", "kv_dim", "padded_vocab", "is_enc_dec"):
        assert getattr(got, prop) == getattr(want, prop), prop
    r_got, r_want = C.reduced(got), RC.reduced(want)
    assert dataclasses.asdict(r_got) == dataclasses.asdict(r_want)
    assert r_got.param_counts() == r_want.param_counts()
    assert r_got.padded_vocab == r_want.padded_vocab
    assert C.get_config(arch) is got


def test_arch_modules_and_registry_equal_reference():
    assert C.list_archs() == RC.list_archs() and len(C.ARCHS) == 10
    for name in ARCH_MODULES:
        got = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
        want = importlib.import_module(f"repro.configs.{name}").CONFIG
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got is C.ARCHS[got.name]
    with pytest.raises(KeyError, match="unknown arch"):
        C.get_config("gpt-5")


def test_shape_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    for arch in C.ARCHS:
        for shape in C.SHAPES:
            assert C.cell_is_runnable(C.ARCHS[arch], C.SHAPES[shape]) == \
                RC.cell_is_runnable(RC.ARCHS[arch], RC.SHAPES[shape])


def test_sharding_tables_equal_reference():
    assert S._TABLES == RS._TABLES
    assert set(S._TABLES) == {"tp", "fsdp_tp", "zero3", "sp_ep"}


@pytest.mark.parametrize("mode", ["tp", "fsdp_tp", "zero3", "sp_ep"])
def test_rules_fingerprint_and_spec_equal_reference(mode):
    over = {"batch": (), "kv_seq": ("data",)}
    for kw in ({}, {"overrides": over}):
        got, want = S.ShardingRules(mode=mode, **kw), \
            RS.ShardingRules(mode=mode, **kw)
        assert got.fingerprint == want.fingerprint
        axes = ("batch", None, "q_dim", "act_vocab")
        assert got.spec(*axes) == tuple(want.spec(*axes))
    with pytest.raises(KeyError):
        S.ShardingRules(mode=mode).spec("no_such_axis")


def test_rules_resolution_no_mesh():
    r = S.ShardingRules(mesh=None)
    assert r.constrain(1.0, "batch") == 1.0
    assert r.sharding("batch") is None
    x = object()
    assert S.NULL_RULES.constrain(x, "batch", "seq", "embed") is x


def test_rules_tables_complete():
    for mode, table in S._TABLES.items():
        for name, axes in table.items():
            assert isinstance(axes, tuple), (mode, name)


def test_mode_tables_well_formed():
    for mode in ("tp", "fsdp_tp", "zero3", "sp_ep"):
        t = S._TABLES[mode]
        for k, v in t.items():
            assert isinstance(v, tuple), (mode, k)
        if mode == "zero3":
            assert t["act_ff"] == () and t["batch"][-1] == "model"
        if mode == "sp_ep":
            assert t["seq"] == ("model",) and t["act_ff"] == ()


def test_rules_over_a_mesh_resolve_and_an_unknown_mode_raises():
    """A mesh is accepted (its dim names filter each name's axes, as the
    reference's axis names do); an unknown mode still raises KeyError."""
    class FakeMesh:
        mesh_dim_names = ("data", "model")
        ndim = 2
        mesh = torch.arange(4).reshape(2, 2)

    r = S.ShardingRules(FakeMesh(), "fsdp_tp")
    assert r.spec("batch", "w_embed", "vocab") == ("data", "data", "model")
    assert r.fingerprint[1] == (("data", "model"), (2, 2), (0, 1, 2, 3))
    x = torch.ones(3)
    assert r.constrain(x, "batch") is x       # a plain tensor: as it is
    assert len(S.pool_rules(2, meshes=[FakeMesh()])) == 2
    with pytest.raises(KeyError, match="unknown sharding mode"):
        S.ShardingRules(mode="dp")
    with pytest.raises(KeyError):
        r.spec("no_such_axis")


def test_pool_rules_without_a_mesh():
    rules = S.pool_rules(3, mode="zero3", overrides={"batch": ()})
    want = RS.pool_rules(3, mode="zero3", overrides={"batch": ()})
    assert len(rules) == 3 and len({id(r) for r in rules}) == 3
    assert [r.fingerprint for r in rules] == [w.fingerprint for w in want]
    assert all(r.mesh is None and r.mode == "zero3" for r in rules)
