"""The port's examples (``src/repro_torch/examples``, ROADMAP A10.6) against
the reference's ``examples/*.py`` on the CPU: each pair runs in this
process at the reference's sizes and seeds, and the printed answers must
be equal line for line. The timing lines (prefill and decode ms, tok/s)
are left out, and the checkpoint directory of ``train_lm`` is each run's
own.

The examples that train or run a model start from the same weights: the
reference example's own (``api.init(jax.random.key(0), cfg)``), handed to
the port's example through ``convert.from_jax``. Both packages compute
in float32 here (``COMPUTE_DTYPE`` set in both ``models/layers.py``): the
same arithmetic in other orders then leaves every greedy token, every
prediction and every printed loss (4 decimals) equal. In bf16 the logits
differ by a few ulps and an argmax with a near tie flips (one of 3,024
predictions and one greedy token of request 0 here), as
tests/test_torch_udf.py and tests/test_torch_serving.py hold them.

``train_lm`` runs the reference with synchronous checkpoints: its restore
picks the latest step before it waits for the save in flight, so with
async saves its rollback at step 20 (the step whose save was just
started) lands on step 10. The port's restore waits first and lands on
20, which is what the reference gives whenever that save has landed.
"""
import contextlib
import io
import pathlib
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.registry import get_api as jget_api
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.udf import model_udf as judf
from repro_torch.configs import get_config
from repro_torch.examples import quickstart, sentiment_pipeline, serve_model, train_lm
from repro_torch.models.convert import from_jax
from repro_torch.udf import model_udf
from test_torch_families import set_dtype

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TIMING = ("prefill:", "decode:")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    judf.clear_registry()
    model_udf.clear_registry()
    yield
    judf.clear_registry()
    model_udf.clear_registry()
    torch.set_num_threads(n)


def _reference(name: str, argv: list, monkeypatch) -> list:
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return _answers(buf.getvalue())


def _port(module, argv: list, capsys, **kw) -> list:
    capsys.readouterr()
    assert module.main(["--device", "cpu"] + argv, **kw) == 0
    return _answers(capsys.readouterr().out)


def _answers(text: str) -> list:
    return [l for l in text.splitlines() if not l.lstrip().startswith(TIMING)]


def _weights():
    """The reference example's initial weights, and the same in the
    port's model."""
    jcfg = jget_config("paper-lm").reduced()
    params = jax.tree_util.tree_map(
        np.asarray, jget_api(jcfg).init(jax.random.key(0), jcfg))
    return from_jax(params, get_config("paper-lm").reduced(), device="cpu")


def test_quickstart_matches_reference(monkeypatch, capsys):
    want = _reference("quickstart", [], monkeypatch)
    assert _port(quickstart, [], capsys) == want
    assert any(l.startswith("plan cache:") for l in want)


def test_serve_model_matches_reference(monkeypatch, capsys):
    set_dtype(monkeypatch, "float32")
    want = _reference("serve_model", [], monkeypatch)
    assert _port(serve_model, [], capsys, model=_weights()) == want
    assert any(l.startswith("sample continuation") for l in want)


def test_sentiment_pipeline_matches_reference(monkeypatch, capsys):
    set_dtype(monkeypatch, "float32")
    want = _reference("sentiment_pipeline", [], monkeypatch)
    assert _port(sentiment_pipeline, [], capsys, model=_weights()) == want
    assert any("persisted demo.negTweets" in l for l in want)


def test_train_lm_matches_reference(monkeypatch, capsys, tmp_path):
    """60 steps, a node failure at 20 and the reference's "nan" at 40,
    which leaves the int-only batch as it is: one recovery, the same
    losses and the same checkpoints kept."""
    set_dtype(monkeypatch, "float32")
    init = JCheckpointManager.__init__
    monkeypatch.setattr(JCheckpointManager, "__init__",
                        lambda self, d, keep=3, async_save=True:
                        init(self, d, keep=keep, async_save=False))
    want = _reference("train_lm", ["--ckpt-dir", str(tmp_path / "ref")], monkeypatch)
    got = _port(train_lm, ["--ckpt-dir", str(tmp_path / "port")], capsys,
                model=_weights())
    assert [l.replace(str(tmp_path / "port"), "DIR") for l in got] == \
        [l.replace(str(tmp_path / "ref"), "DIR") for l in want]
    assert "recoveries: [(20, 'NodeFailure: injected node failure at step 20')]" \
        in want[-2]
