"""The port's training launcher (ROADMAP A10.5) on the CPU: ``main`` runs a
reduced model through the fault-tolerant loop and resumes from its
checkpoints; its batches are the reference launcher's draws
(``default_rng(777 + i)``: tokens, and bf16 frames / patches, compared
bit for bit with the reference's ``jnp.asarray(..., jnp.bfloat16)``); a
run cut by a resume ends bit-equal to one run straight through (the same
arithmetic from the same restored state and batches); the reference's
mesh flags raise on one device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.runtime.tree import flatten

ARGS = ["--device", "cpu", "--reduced", "--arch", "qwen3-1.7b",
        "--global-batch", "2", "--seq", "16", "--ckpt-every", "2"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_main_runs_then_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert train.main(ARGS + ["--steps", "4", "--ckpt-dir", ck]) == 0
    out = capsys.readouterr().out
    assert "[cpu] using reduced config qwen3-1.7b-smoke" in out
    assert [l.split()[1] for l in out.splitlines() if l.startswith("step ")] == \
        ["0", "1", "2", "3"]
    assert "events: none" in out
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == \
        ["step_0", "step_2", "step_4"]
    assert train.main(ARGS + ["--steps", "6", "--ckpt-dir", ck, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 4" in out
    assert [l.split()[1] for l in out.splitlines() if l.startswith("step ")] == \
        ["4", "5"]
    # the resumed run's state equals one run straight through
    cfg = get_config("qwen3-1.7b").reduced()
    straight = train.run(cfg, 6, 2, 16, tmp_path / "straight", 2, device="cpu")
    cut = train.run(cfg, 6, 2, 16, ck, 2, resume=True, device="cpu")
    assert cut["start"] == 6 and cut["log"] == []
    want, _ = flatten(convert.train_state_tree(straight["model"],
                                               straight["opt_state"], cfg))
    got, _ = flatten(convert.train_state_tree(cut["model"], cut["opt_state"], cfg))
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and np.array_equal(w, g), i


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-base",
                                  "llava-next-mistral-7b"])
def test_batches_are_the_reference_launchers(arch):
    """Step i's batch: ``default_rng(777 + i)``'s tokens (B, S) int32, then
    frames (encdec) or patches (vlm) drawn by the same generator, in bf16
    bit for bit as the reference converts them."""
    cfg = get_config(arch).reduced()
    it = train.data_factory(cfg, 3, 8, "cpu")(5)
    for i in (5, 6):
        got = next(it)
        rng = np.random.default_rng(777 + i)
        want = {"tokens": np.asarray(jnp.asarray(
            rng.integers(0, cfg.vocab, (3, 8)), jnp.int32))}
        if cfg.family == "encdec":
            want["frames"] = np.asarray(jnp.asarray(
                rng.normal(size=(3, cfg.enc_len, cfg.d_model)), jnp.bfloat16))
        if cfg.family == "vlm":
            want["patches"] = np.asarray(jnp.asarray(
                rng.normal(size=(3, cfg.num_patches, cfg.patch_dim)), jnp.bfloat16))
        assert set(got) == set(want)
        assert got["tokens"].dtype == torch.int32
        assert np.array_equal(got["tokens"].numpy(), want["tokens"])
        for k in set(want) - {"tokens"}:
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(got[k].view(torch.int16).numpy(),
                                  want[k].view(np.int16))


def test_large_config_reduced_off_the_card(tmp_path, capsys):
    """Off the card a config above 5e8 parameters is reduced, as the
    reference reduces it off a TPU."""
    assert train.main(["--device", "cpu", "--arch", "qwen3-1.7b", "--steps", "1",
                       "--global-batch", "1", "--seq", "8",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "using reduced config qwen3-1.7b-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--multi-pod"], ["--local-devices", "8"]])
def test_mesh_flags_wait_for_several_cards(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="A9b"):
        train.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)] + flag)


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(get_config("paper-lm").reduced(), 1, 1, 8, tmp_path)
