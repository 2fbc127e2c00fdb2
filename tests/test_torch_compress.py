"""The port's gradient compression (ROADMAP A10.4, the local half) against
the JAX reference on the CPU: tests/test_runtime.py's compression checks
replayed on ``repro_torch.runtime.compress``, and every function bit for
bit against the reference's on seeded inputs (tolerance 0: both round
half to even and divide in float32), exact .5 ties and an all-zero leaf
included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compress as J
from repro_torch.runtime import compress as T
from repro_torch.runtime.tree import flatten


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def assert_bit_equal(got, want, what: str) -> None:
    gl, _ = flatten(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} leaf {i}"
        assert np.array_equal(_bits(g), _bits(w)), f"{what} leaf {i}"


def _grads(seed: int) -> dict:
    """Seeded float32 leaves: wide, tiny, an all-zero one, and one whose
    scale is exactly 1 (max |x| = 127) holding exact .5 ties."""
    rng = np.random.default_rng(seed)
    ties = np.array([127.0, 2.5, 3.5, -0.5, -1.5, 0.5, 126.5, -126.5, 64.5],
                    np.float32)
    return {"w": rng.normal(size=(257, 3)).astype(np.float32),
            "layers": {"b": (rng.normal(size=(31,)) * 1e-3).astype(np.float32),
                       "zero": np.zeros((4, 4), np.float32)},
            "ties": ties}


# -- tests/test_runtime.py:78-106 replayed ---------------------------------------

def test_compress_error_feedback_accumulates_correctly():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(1000,))
                               .astype(np.float32))}
    e = T.init_error_state(g)
    acc_true = np.zeros(1000)
    acc_q = np.zeros(1000)
    for _ in range(50):
        qs, ss, e = T.compress_grads(g, e)
        acc_true += g["w"].numpy()
        acc_q += T.decompress_grads(qs, ss)["w"].numpy()
    rel = np.abs(acc_true - acc_q).max() / np.abs(acc_true).max()
    assert rel < 1e-2


def test_compress_training_convergence():
    """int8 error-feedback grads still minimize a least-squares problem."""
    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    w = torch.zeros(16)
    loss = lambda w: torch.mean((A @ w - y) ** 2)
    err = T.init_error_state({"w": w})
    for _ in range(200):
        g = {"w": 2 * A.T @ (A @ w - y) / A.shape[0]}
        qs, ss, err = T.compress_grads(g, err)
        w = w - 0.05 * T.decompress_grads(qs, ss)["w"]
    w_exact = torch.linalg.lstsq(A, y[:, None]).solution[:, 0]
    assert float(loss(w)) < float(loss(w_exact)) * 1.05


# -- bit for bit against the reference -----------------------------------------------

def test_quantize_matches_reference_bit_for_bit():
    for seed in range(3):
        for x in jax.tree_util.tree_leaves(_grads(seed)):
            jq, js = J.quantize(jnp.asarray(x))
            tq, ts = T.quantize(torch.from_numpy(x))
            assert_bit_equal((tq, ts), (jq, js), "quantize")
            assert_bit_equal(T.dequantize(tq, ts), J.dequantize(jq, js), "dequantize")
    jq, _ = J.quantize(jnp.asarray(_grads(0)["ties"]))
    # half to even: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0, -1.5 -> -2, 126.5 -> 126
    assert np.asarray(jq).tolist() == [127, 2, 4, 0, -2, 0, 126, -126, 64]
    assert not np.asarray(J.quantize(jnp.zeros(3))[0]).any()


def test_quantize_bf16_matches_reference():
    """The reference's scale of a bf16 leaf is bf16 (weak float types):
    the port's too."""
    x = np.random.default_rng(4).normal(size=300).astype(np.float32)
    jq, js = J.quantize(jnp.asarray(x, jnp.bfloat16))
    tq, ts = T.quantize(torch.from_numpy(x).bfloat16())
    assert ts.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert float(js) == float(ts)


def test_error_feedback_matches_reference_bit_for_bit():
    """Ten steps of error feedback over a tree: payloads, scales and error
    states equal the reference's at every step."""
    grads = [_grads(s) for s in range(10)]
    je = J.init_error_state(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    te = T.init_error_state(jax.tree_util.tree_map(torch.from_numpy, grads[0]))
    assert_bit_equal(te, je, "init_error_state")
    for g in grads:
        jq, js, je = J.compress_grads(jax.tree_util.tree_map(jnp.asarray, g), je)
        tq, ts, te = T.compress_grads(jax.tree_util.tree_map(torch.from_numpy, g), te)
        assert_bit_equal((tq, ts, te), (jq, js, je), "compress_grads")
        assert_bit_equal(T.decompress_grads(tq, ts), J.decompress_grads(jq, js),
                         "decompress_grads")


def test_structures_must_agree_and_psum_waits_for_several_cards():
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError):
        T.compress_grads(g, {"v": torch.zeros(3)})
    with pytest.raises(ValueError):
        T.decompress_grads({"w": torch.ones(3, dtype=torch.int8)}, {})
    # the all-reduce over a mesh's data shards runs on one card now
    # (tests/test_torch_mesh_models.py holds it to the reference); its
    # shard trees must agree as well
    with pytest.raises(ValueError):
        T.compressed_psum([g, {"v": torch.ones(3)}], [T.init_error_state(g)] * 2)
    mean, errs = T.compressed_psum([g, g], [T.init_error_state(g)] * 2)
    assert torch.equal(mean["w"], g["w"]) and len(errs) == 2
