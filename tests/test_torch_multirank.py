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


@pytest.fixture(scope="module")
def ag_ranks(tmp_path_factory):
    """One spawn over a (4,) "model" mesh: ag_matmul and heads_local."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(8, 12).astype(np.float32)
    return x, w, R.run_ranks(R.rank_ag_matmul, WORLD,
                             tmp_path_factory.mktemp("ag"), x, w)


def test_collective_matmul_matches_matmul(ag_ranks):
    x, w, out = ag_ranks
    for r in out:
        assert r["placements"] == ["S(1)"] and r["local_shape"] == (16, 3)
        np.testing.assert_allclose(r["y"], x @ w, rtol=1e-5, atol=1e-5)


def test_heads_local_matches_plain_attention(ag_ranks):
    """Attention with each rank's block of the heads over 4 ranks equals
    the plain attention: KV heads split (4 KV heads), query heads of a
    group split (1 KV head, 4 a group), and 6 heads that 4 ranks do not
    divide (ranks 0-2 two heads each, rank 3 none, gathered whole); the
    gradients of q, k and v too."""
    for rank, r in enumerate(ag_ranks[2]):
        for (hkv, g), (got, want, local) in r["heads"].items():
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            if (hkv, g) == (4, 2):
                assert local == (2, 16, 1, 2, 8)
            elif (hkv, g) == (1, 4):
                assert local == (2, 16, 1, 1, 8)
            else:
                assert local == (2, 16, 2, 3, 8)   # gathered whole


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


@pytest.fixture(scope="module")
def train_step_ranks(tmp_path_factory):
    """One spawn for the train-step tests: the TP + DP step without and
    with int8 error feedback, and the error-feedback round trip of one
    gradient (a (12, 40) f32 leaf: 480 elements, so 2 blocks of 256 whose
    boundary falls inside the second rank's `Shard(1)` columns)."""
    _, _, params = _ref("llama3.2-3b")
    grad = np.random.RandomState(7).randn(12, 40).astype(np.float32)
    grad[:, :10] *= 50.0          # one block's scale far above the other's
    out = R.run_ranks(R.rank_train_step, WORLD,
                      tmp_path_factory.mktemp("train_step"), params,
                      _tokens(1, (4, 16)), grad)
    return grad, out


def test_train_step_sharded_matches_single_device(train_step_ranks):
    """One TP + DP step over (2, 2) == the single-device step (reduced
    llama3.2-3b, f32): loss 1e-4, parameters 1e-3."""
    for r in train_step_ranks[1]:
        r = r["plain"]
        one, mesh = r["loss"]
        assert abs(one - mesh) < 1e-4
        assert r["param_diff"] < 1e-3, r["param_diff"]
        assert r["metrics_plain"]
        # tp shards the embedding's vocab and every projection
        assert "emb.tok" in r["sharded"] and len(r["sharded"]) == 15


def test_train_step_compressed_sharded_matches_single_device(
        train_step_ranks):
    """The same step with `compress_grads=True` (int8 error feedback in
    the blocks of the whole flattened gradient) at the same tolerances;
    a residual it keeps moves by at most one code step (a gradient one ulp
    apart may round to the neighbouring code)."""
    for r in train_step_ranks[1]:
        r = r["compressed"]
        one, mesh = r["loss"]
        assert abs(one - mesh) < 1e-4
        assert r["param_diff"] < 1e-3, r["param_diff"]
        assert r["residual_steps"] <= 1.01, r["residual_steps"]
        assert r["residual_sharded"] and r["metrics_plain"]
        assert "emb.tok" in r["sharded"] and len(r["sharded"]) == 15


def test_error_feedback_sharded_bitwise(train_step_ranks):
    """compress_grads_ef of one gradient `Shard(1)` over 4 ranks: the
    dequantized gradient and the new residual are bitwise the plain
    tensor's, and come back on the gradient's placements."""
    grad, out = train_step_ranks
    for r in out:
        ef = r["ef"]
        assert ef["placements"] == ["S(1)", "S(1)"]
        for plain, sharded in zip(ef["plain"], ef["sharded"]):
            assert plain.shape == grad.shape
            np.testing.assert_array_equal(sharded, plain)
    # the round trip really quantized: the residual is not zero
    assert abs(out[0]["ef"]["plain"][1]).max() > 0


@pytest.fixture(scope="module")
def loss_ranks(tmp_path_factory):
    """One spawn: llama3.2-3b under zero3 and granite-moe-3b-a800m under
    sp_ep over (2, 2), and llama's gradients under zero3, sp_ep and tp."""
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
    out = R.run_ranks(R.rank_losses, WORLD,
                      tmp_path_factory.mktemp("losses"), cases, tokens,
                      ("zero3", "sp_ep", "tp"))
    return ref_loss, out


def test_zero3_and_sp_ep_match_unsharded_loss(loss_ranks):
    """llama3.2-3b under zero3 and granite-moe-3b-a800m under sp_ep over
    (2, 2): losses within 2e-3 of unsharded; the unsharded llama loss
    within 1e-5 of the reference's."""
    ref_loss, out = loss_ranks
    for r in out:
        (plain_llama, llama), (plain_moe, moe) = r[:2]
        assert abs(plain_llama - ref_loss) < 1e-5
        assert abs(llama - plain_llama) < 2e-3
        assert abs(moe - plain_moe) < 2e-3


def test_sharded_gradients_match_unsharded(loss_ranks):
    """llama3.2-3b's gradients with the state placed by zero3, sp_ep and
    tp over (2, 2) within 1e-4 of the unsharded ones (relative to each
    leaf's largest): the projections of sp_ep's stream, run on each rank's
    rows, sum their weights' gradients over the ranks."""
    for r in loss_ranks[1]:
        for mode, err in r[2].items():
            assert err < 1e-4, (mode, err)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_elastic_restart_reshards_onto_another_mesh(tmp_path, arch):
    """Saved under (2, 2), restored with `shardings=` onto the (4, 1) mesh
    of `plan_mesh(4, model_parallel=1)`: every parameter and state leaf
    comes back equal to what was saved, and the losses of two further
    steps are within 1e-5 of the straight run's (reduced f32, tp mode;
    granite-moe with its 8-bit state, whose row scales do not depend on
    the layout). The parameters after them are within 1e-5 of the straight
    run's, except where the two meshes' reduction orders move a decision:
    an element whose gradient is below 1e-4 of its leaf's largest in
    either step (Adam's sign step), or, with the 8-bit state, whose m code
    or bf16 v rounded to a neighbour of the straight run's. Those stay
    below one step's lr."""
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
        assert r["param_diff"] < 1e-5, r["param_diff"]
        assert r["param_diff_exempt"] < 1e-2   # below one step's lr
        if arch == "llama3.2-3b":           # f32 state: nothing rounds
            assert r["rounded_state_elements"] == 0
