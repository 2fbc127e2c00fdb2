"""The port's checkpoints (ROADMAP A10.2) against the JAX reference on the
CPU: tests/test_runtime.py's checkpoint checks replayed on
``repro_torch.runtime.checkpoint``, the tree order of ``runtime/tree.py``
against ``jax.tree_util``, and checkpoints crossing packages both ways on
a reduced qwen3's train state (the reference's stacked pytree, one AdamW
step in so that m, v and step are not zeros).

Every comparison is exact (bit for bit, dtype included): a checkpoint
stores arrays, and both packages write the same bytes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.launch.train import ModelState
from repro_torch.models import convert
from repro_torch.models.optim import init_opt_state
from repro_torch.runtime import tree as T
from repro_torch.runtime.checkpoint import CheckpointManager
from test_torch_families import cfgs, ref_params
from test_torch_train import _ref_train_step


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def assert_trees_equal(got, want, what: str) -> None:
    """Same structure (the reference's order), and every leaf equal bit
    for bit with the same dtype and shape."""
    gl, gd = T.flatten(got)
    wl, wd = jax.tree_util.tree_flatten(want)
    assert str(gd) == str(wd), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} leaf {i}"
        assert np.array_equal(_bits(g), _bits(w)), f"{what} leaf {i}"


# -- tests/test_runtime.py:14-37, 108-122 replayed ------------------------------

def test_checkpoint_roundtrip_keepn_crc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_save=True)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    for s in (1, 2, 3):
        cm.save(s, T.tree_map(lambda x: x * s, tree))
    cm.wait()
    assert cm.steps() == [2, 3]
    s, t = cm.restore(None, tree, device="cpu")
    assert s == 3
    np.testing.assert_allclose(t["a"], np.arange(10.0) * 3)
    s, t = cm.restore(2, tree, device="cpu")
    np.testing.assert_allclose(t["b"]["c"], np.ones((3, 3)) * 2)


def test_checkpoint_corruption_detected(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_save=False)
    cm.save(1, {"a": torch.arange(4.0)})
    leaf = tmp_path / "step_1" / "leaf_0.npy"
    a = np.load(leaf)
    a[0] = 999.0
    np.save(leaf, a)
    with pytest.raises(IOError, match="crc"):
        cm.restore(1, {"a": torch.arange(4.0)}, device="cpu")


def test_restore_onto_a_named_device(tmp_path):
    """The port's counterpart of the elastic restore: the full leaves go
    onto the device named; without a name the card is meant, which
    raises where there is none."""
    cm = CheckpointManager(tmp_path, async_save=False)
    tree = {"w": torch.arange(16.0).reshape(4, 4), "s": torch.tensor(3, dtype=torch.int32)}
    cm.save(5, tree)
    step, t = cm.restore(None, tree, device="cpu")
    assert step == 5
    for k in tree:
        assert t[k].device.type == "cpu" and t[k].dtype == tree[k].dtype
        assert torch.equal(t[k], tree[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cm.restore(None, tree)


# -- the format --------------------------------------------------------------------

def test_tree_order_and_text_match_jax():
    """Dict keys sorted (``opt`` before ``params``; ``m``, ``step``, ``v``),
    lists and tuples in order, ``None`` and ``{}`` with no leaf; the
    structure's text is the reference's ``PyTreeDef``."""
    trees = [{"params": {"w": 1, "b": 2}, "opt": {"v": 3, "step": 4, "m": 5}},
             {"b": {"c": 1, "a": None, "e": {}}, "a": [1, (2, 3)], "z": 0},
             {"params": 1, "opt": {}}, (1,), [None, {"x": ()}]]
    for t in trees:
        want_leaves, want_def = jax.tree_util.tree_flatten(t)
        got_leaves, got_def = T.flatten(t)
        assert got_leaves == want_leaves
        assert str(got_def) == str(want_def)
        assert got_def.num_leaves == len(want_leaves)
        assert T.unflatten(got_def, got_leaves) == \
            jax.tree_util.tree_unflatten(want_def, want_leaves)
    with pytest.raises(ValueError):
        T.unflatten(T.flatten(trees[0])[1], [1, 2])


def test_save_refuses_what_numpy_cannot_hold(tmp_path):
    """A bf16 leaf is never cast to be saved; a restore into a tree whose
    leaf has another dtype or shape raises instead of casting."""
    cm = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(TypeError):
        cm.save(0, {"w": torch.ones(3, dtype=torch.bfloat16)})
    cm.save(1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="wants"):
        cm.restore(1, {"w": torch.ones(3, dtype=torch.float64)}, device="cpu")
    with pytest.raises(ValueError, match="wants"):
        cm.restore(1, {"w": torch.ones(4)}, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        cm.restore(1, {"w": torch.ones(3), "x": torch.ones(1)}, device="cpu")


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """Save, then change the model and its AdamW state in place at once
    (as the next train step does): the restore gives the state before the
    change, for tensor leaves and for the model's train state alike."""
    cm = CheckpointManager(tmp_path, keep=3, async_save=True)
    w = torch.arange(1 << 16, dtype=torch.float32)
    cm.save(1, {"w": w})
    w.add_(1.0)
    _, t = cm.restore(1, {"w": w}, device="cpu")
    assert torch.equal(t["w"], torch.arange(1 << 16, dtype=torch.float32))

    jcfg, tcfg = cfgs("qwen3-1.7b")
    model = convert.from_jax(ref_params(jcfg), tcfg, device="cpu")
    opt = init_opt_state(model)
    state = ModelState(tcfg)
    before = convert.train_state_tree(model, opt, tcfg)
    cm.save(2, state.tree(model, opt))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
        for mom in (opt["m"], opt["v"]):
            for t in mom.values():
                t.add_(1.0)
        opt["step"] += 7
    step, model, opt = state.restore(cm, model, opt)
    assert step == 2
    assert_trees_equal(convert.train_state_tree(model, opt, tcfg), before,
                       "restored after an in-place change")


def test_writer_failure_is_raised_by_wait(tmp_path):
    """A background write that fails is raised to the caller at the next
    wait (here, the next save), never lost."""
    cm = CheckpointManager(tmp_path, async_save=True)
    (tmp_path / ".tmp_step_1").write_text("a file where the writer wants a directory")
    cm.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        cm.wait()
    cm.save(2, {"w": torch.ones(2)}, wait=True)
    assert cm.steps() == [2]


# -- checkpoints across packages -------------------------------------------------------

@pytest.fixture(scope="module")
def ref_state():
    """A reduced qwen3's train state as the reference's pytree (numpy
    leaves) after one jitted reference train step from the port-drawn
    weights: {"params", "opt": {"m", "v", "step"}}."""
    jcfg, _ = cfgs("qwen3-1.7b")
    params = jax.tree_util.tree_map(jnp.asarray, ref_params(jcfg))
    from repro.models.optim import init_opt_state as jinit

    rng = np.random.default_rng(3)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (2, 16)), jnp.int32)}
    p, o, _ = _ref_train_step(jcfg, "bfloat16")(params, jinit(params), batch)
    return jax.tree_util.tree_map(np.asarray, {"params": p, "opt": o})


def _port_state(state: dict):
    """A port model and AdamW state holding the reference tree's values."""
    _, tcfg = cfgs("qwen3-1.7b")
    model = convert.from_jax(state["params"], tcfg, device="cpu")
    opt = init_opt_state(model)
    convert.load_train_state(T.tree_map(lambda a: torch.from_numpy(np.array(a)), state),
                             model, opt, tcfg)
    return tcfg, model, opt


def test_reference_checkpoint_restores_in_the_port(tmp_path, ref_state):
    """The reference writes (``async_save=False``); the port restores it in
    place into a model built by ``from_jax`` of other weights: every
    parameter, moment and the step bit-equal to the reference's tree, and
    the parameters to ``from_jax``'s of the saved ones."""
    JCheckpointManager(tmp_path, async_save=False).save(1, ref_state)
    _, tcfg = cfgs("qwen3-1.7b")
    model = convert.from_jax(ref_params(cfgs("qwen3-1.7b")[0], seed=5), tcfg,
                             device="cpu")
    opt = init_opt_state(model)
    step, model, opt = ModelState(tcfg).restore(CheckpointManager(tmp_path), model, opt)
    assert step == 1 and int(opt["step"]) == 1
    assert_trees_equal(convert.train_state_tree(model, opt, tcfg), ref_state,
                       "port restore of a reference checkpoint")
    direct = convert.from_jax(ref_state["params"], tcfg, device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(), direct.named_parameters()):
        assert torch.equal(p, q), n


def test_port_checkpoint_restores_in_the_reference(tmp_path, ref_state):
    """The port writes the same state from its model; the reference
    restores it into its ``like``, bit-equal; the two checkpoints' leaf
    files are byte-identical and their meta agree."""
    tcfg, model, opt = _port_state(ref_state)
    CheckpointManager(tmp_path / "port", async_save=False).save(
        1, convert.train_state_tree(model, opt, tcfg))
    JCheckpointManager(tmp_path / "ref", async_save=False).save(1, ref_state)
    like = jax.tree_util.tree_map(jnp.zeros_like, ref_state)
    step, got = JCheckpointManager(tmp_path / "port").restore(None, like)
    assert step == 1
    assert_trees_equal(ref_state, got, "reference restore of a port checkpoint")

    port, ref = tmp_path / "port" / "step_1", tmp_path / "ref" / "step_1"
    pm = json.loads((port / "meta.json").read_text())
    rm = json.loads((ref / "meta.json").read_text())
    assert pm == rm   # step, num_leaves, crc and the structure's text
    assert pm["num_leaves"] == len(jax.tree_util.tree_leaves(ref_state))
    for i in range(pm["num_leaves"]):
        assert (port / f"leaf_{i}.npy").read_bytes() == \
            (ref / f"leaf_{i}.npy").read_bytes(), f"leaf_{i}.npy"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_corrupted_leaf_raises_crc_in_both(tmp_path, ref_state, writer):
    """One flipped byte in a leaf's data: both packages' restores raise
    with "crc", whichever wrote the checkpoint."""
    tcfg, model, opt = _port_state(ref_state)
    if writer == "port":
        CheckpointManager(tmp_path, async_save=False).save(
            1, convert.train_state_tree(model, opt, tcfg))
    else:
        JCheckpointManager(tmp_path, async_save=False).save(1, ref_state)
    leaf = tmp_path / "step_1" / "leaf_3.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-5] ^= 0x40
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        ModelState(tcfg).restore(CheckpointManager(tmp_path), model, opt)
    with pytest.raises(IOError, match="crc"):
        JCheckpointManager(tmp_path).restore(1, ref_state)


def test_train_state_layout_round_trips(ref_state):
    """``train_state_tree`` lays the model out as the reference's stacked
    tree (the same structure as ``to_jax`` beside the AdamW state), and
    ``load_train_state`` writes it back block by block; a leaf of another
    dtype or shape is refused, not cast."""
    tcfg, model, opt = _port_state(ref_state)
    tree = convert.train_state_tree(model, opt, tcfg)
    assert_trees_equal(tree, ref_state, "train_state_tree")
    assert str(T.flatten(convert.train_state_like(model, opt, tcfg))[1]) == \
        str(jax.tree_util.tree_structure(ref_state))
    assert_trees_equal(tree["params"], convert.to_jax(model, tcfg), "to_jax")
    bad = T.tree_map(torch.from_numpy, tree)
    bad["opt"]["step"] = bad["opt"]["step"].to(torch.int64)
    with pytest.raises(ValueError, match="step"):
        convert.load_train_state(bad, model, opt, tcfg)
    bad = T.tree_map(torch.from_numpy, tree)
    bad["params"]["embed"] = bad["params"]["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        convert.load_train_state(bad, model, opt, tcfg)
