"""The reference's multi-device tests on the port, over 4 gloo ranks on the
CPU (each rank a process, the group over a `FileStore` in the test's
temporary directory, every rank with a deadline: `torch_ranks.run_ranks`):
the collective matmul against the plain product, the preprocessing
pipeline with its batch over "data" against the single-process run, a
TP + DP train step against one device, the zero3 and sp_ep losses against
unsharded ones, and an elastic restart onto another mesh.

The models are the port's reduced f32 configs with the reference's
`init(jax.random.key(0))` weights (`load_reference_params`); one unsharded
loss is held against the reference's, so the chain reaches the JAX
package. Tolerances are the reference's own."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.configs import ARCHS as RARCHS, reduced as rreduced  # noqa: E402
from repro.distributed.sharding import NULL_RULES as RNULL  # noqa: E402
from repro.models.zoo import build_model as rbuild  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core.plans import Preprocessor  # noqa: E402
from repro_torch.data.synthetic import generate_labelled  # noqa: E402

WORLD = 4


def _ref(arch):
    """The reference's reduced f32 model and its key-0 parameters (numpy)."""
    rcfg = dataclasses.replace(rreduced(RARCHS[arch]), dtype="float32")
    model = rbuild(rcfg)
    params = model.init(jax.random.key(0))
    return model, params, jax.tree.map(np.asarray, params)


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 512, shape).astype(
        np.int64)


def test_collective_matmul_matches_matmul(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(8, 12).astype(np.float32)
    out = R.run_ranks(R.rank_ag_matmul, WORLD, tmp_path, x, w)
    for r in out:
        assert r["placements"] == ["S(1)"] and r["local_shape"] == (16, 3)
        np.testing.assert_allclose(r["y"], x @ w, rtol=1e-5, atol=1e-5)


def test_pipeline_sharded_matches_single_device(tmp_path):
    """Identical masks under 4-way data parallelism (the paper's
    distribution-invariance requirement), wave5 within 2e-4; the whole
    two-phase call keeps the same rows, cleaned within 2e-4."""
    out = R.run_ranks(R.rank_pipeline, WORLD, tmp_path, 3, timeout=300)
    audio, _ = generate_labelled(3, 4 * 12, segment_s=5.0)
    s5 = audio.shape[-1]
    chunks = (audio.reshape(4, 12, 2, s5).transpose(0, 2, 1, 3)
              .reshape(4, 2, 12 * s5))
    one = Preprocessor(cfg, device="cpu")
    det = one.detect(chunks)
    res = one(chunks)
    for r in out:
        assert r["device"] == "cpu" and r["pad"] == WORLD
        np.testing.assert_array_equal(r["keep"], det.keep.numpy())
        np.testing.assert_allclose(r["wave5"], det.wave5.numpy(),
                                   atol=2e-4)
        for k, v in det.stats.items():
            assert abs(r["stats"][k] - float(v)) < 1e-6, k
        np.testing.assert_array_equal(r["res_keep"], res.det.keep.numpy())
        assert r["n_kept"] == res.n_kept > 0
        np.testing.assert_allclose(r["cleaned"], res.cleaned, atol=2e-4)


def test_train_step_sharded_matches_single_device(tmp_path):
    """One TP + DP step over (2, 2) == the single-device step (reduced
    llama3.2-3b, f32): loss 1e-4, parameters 1e-3."""
    _, _, params = _ref("llama3.2-3b")
    out = R.run_ranks(R.rank_train_step, WORLD, tmp_path, params,
                      _tokens(1, (4, 16)))
    for r in out:
        one, mesh = r["loss"]
        assert abs(one - mesh) < 1e-4
        assert r["param_diff"] < 1e-3, r["param_diff"]
        assert r["metrics_plain"]
        # tp shards the embedding's vocab and every projection
        assert "emb.tok" in r["sharded"] and len(r["sharded"]) == 15


def test_zero3_and_sp_ep_match_unsharded_loss(tmp_path):
    """llama3.2-3b under zero3 and granite-moe-3b-a800m under sp_ep over
    (2, 2): losses within 2e-3 of unsharded; the unsharded llama loss
    within 1e-5 of the reference's."""
    tokens = _tokens(1, (4, 32))
    cases, ref_loss = [], None
    for arch, mode in (("llama3.2-3b", "zero3"),
                       ("granite-moe-3b-a800m", "sp_ep")):
        model, jparams, params = _ref(arch)
        cases.append((arch, mode, params))
        if ref_loss is None:
            batch = {"tokens": jnp.asarray(tokens),
                     "targets": jnp.asarray(tokens)}
            ref_loss = float(model.loss_fn(jparams, batch, RNULL)[0])
    out = R.run_ranks(R.rank_losses, WORLD, tmp_path, cases, tokens)
    for r in out:
        (plain_llama, llama), (plain_moe, moe) = r
        assert abs(plain_llama - ref_loss) < 1e-5
        assert abs(llama - plain_llama) < 2e-3
        assert abs(moe - plain_moe) < 2e-3


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_elastic_restart_reshards_onto_another_mesh(tmp_path, arch):
    """Saved under (2, 2), restored with `shardings=` onto the (4, 1) mesh
    of `plan_mesh(4, model_parallel=1)`: every parameter and state leaf
    comes back equal to what was saved, and the losses of two further
    steps are within 1e-5 of the straight run's (reduced f32, tp mode;
    granite-moe with its 8-bit state, whose row scales do not depend on
    the layout). The parameters after them differ only by the two meshes'
    reduction orders, which Adam amplifies on near-zero gradients."""
    _, _, params = _ref(arch)
    tokens = [_tokens(s, (4, 16)) for s in (1, 2, 3, 4)]
    out = R.run_ranks(R.rank_elastic_restart, WORLD, tmp_path, arch, params,
                      tokens, str(tmp_path / "ckpt"))
    for r in out:
        assert r["plan"] == ((4, 1), ("data", "model"))
        assert r["meta"] == {"step": 2}
        assert r["meshes"] == [(4, 1)]
        assert r["restore_diff"] == 0.0 and r["leaves"] > 30
        np.testing.assert_allclose(r["resumed"], r["straight"], rtol=0,
                                   atol=1e-5)
        assert r["param_diff"] < 1e-2       # below one step's lr
