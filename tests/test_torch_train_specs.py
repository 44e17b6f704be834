"""The training state's sharding specs and the name <-> reference-layout
maps of the port against the JAX package, for the ten archs at their
`reduced` configs: `train_state_specs` keyed by parameter name equals the
reference's stacked specs with the layer axis split off, `tree_shardings`
is None without a mesh as in the reference, and `to_reference_tree`
inverts `load_reference_params` leaf for leaf."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, reduced as rreduced
from repro.distributed.sharding import NULL_RULES as RR
from repro.distributed.sharding import tree_shardings as rtree_shardings
from repro.models.zoo import build_model as rbuild
from repro.train.optimizer import OptConfig as ROptConfig
from repro.train.train_step import train_state_specs as rtrain_state_specs
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.sharding import NULL_RULES, tree_shardings
from repro_torch.models.reference_params import (load_reference_params,
                                                 to_reference_tree)
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import train_state_specs


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _split_reference(model, ref_specs):
    """The reference's stacked spec tree keyed as the port's parameters:
    each leaf of a group the port keeps as a layer list, one entry a layer
    without the leading layer axis."""
    stacked = {n: len(m) for n, m in model.named_children()
               if isinstance(m, torch.nn.ModuleList)}
    out = {}
    for path, spec in _flat(ref_specs):
        if path[0] in stacked:
            assert spec[0] is None                  # the layer axis
            for i in range(stacked[path[0]]):
                out[".".join((path[0], str(i)) + path[1:])] = spec[1:]
        else:
            out[".".join(path)] = spec
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("compress", [False, True])
def test_train_state_specs_match_reference(arch, compress):
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg, device="cpu")
    opt = OptConfig(quantize_state=cfg.quantize_opt_state or compress)
    ropt = ROptConfig(quantize_state=opt.quantize_state)
    pspecs, ospecs = train_state_specs(model, opt, compress)
    rp, ro = rtrain_state_specs(rbuild(rreduced(RARCHS[arch])), ropt,
                                compress)
    params = dict(model.named_parameters())
    assert set(pspecs) == set(params)
    for name, spec in pspecs.items():
        assert isinstance(spec, tuple) and len(spec) == params[name].ndim
    assert pspecs == _split_reference(model, rp)
    assert set(ospecs) == set(ro) == ({"master", "m", "v", "step"}
                                      | ({"ef_residual"} if compress
                                         else set()))
    assert ospecs["step"] == ro["step"] == ()
    for part in ("master", "v") + (("ef_residual",) if compress else ()):
        assert ospecs[part] == pspecs
    for name, spec in pspecs.items():
        m = ospecs["m"][name]
        if opt.quantize_state:
            assert m == {"codes": spec, "scale": spec[:-1]}
        else:
            assert m == spec
    assert tree_shardings(NULL_RULES, ospecs) is None
    assert rtree_shardings(RR, ro) is None


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_to_reference_tree_inverts_load(arch):
    rcfg = rreduced(RARCHS[arch])
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        rbuild(rcfg).init(jax.random.key(0)))
    model = load_reference_params(build_model(reduced(ARCHS[arch]),
                                              device="cpu"), tree)
    back = to_reference_tree(model, dict(model.named_parameters()))
    got, want = dict(_flat(back)), dict(_flat(tree))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == np.float32
        # the reference's own dtypes (bf16 leaves as f32) come back exactly
        np.testing.assert_array_equal(g, w)


def test_to_reference_tree_rejects_a_missing_layer():
    model = build_model(reduced(ARCHS["llama3.2-3b"]), device="cpu")
    values = {n: p for n, p in model.named_parameters()
              if not n.startswith("layers.1.")}
    with pytest.raises(ValueError, match="layers"):
        to_reference_tree(model, values)
