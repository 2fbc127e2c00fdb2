"""Model UDFs on the port (paper §III-C, Figs. 4-6): the scenario of
``tests/test_ingest_udf.py`` replayed on ``repro_torch`` at device="cpu" in
kernel and gspmd modes, and the port's predictions held against the
reference's session on the same tokens and converted weights.

Predictions are an argmax over three logits. In float32 compute both
packages do the same arithmetic in different orders, so every row agrees.
In bf16 the logits differ by up to 5e-2 (tests/test_torch_models.py), so a
row whose top-2 margin is within 2 x 5e-2 may flip: rows are compared
where the reference's margin exceeds 0.1."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
from repro.configs import get_config as jget_config
from repro.core.frame import AFrame as JFrame
from repro.engine.session import Session as JSession
from repro.engine.table import Table as JTable
from repro.models import transformer as jtf
from repro.udf import model_udf as judf
from repro_torch.configs import get_config
from repro_torch.core import plan as P
from repro_torch.core.frame import AFrame
from repro_torch.engine.session import Session
from repro_torch.engine.table import Table
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import lm_from_jax
from repro_torch.udf import model_udf

N, SEQ, MICROBATCH, MARGIN = 256, 16, 100, 0.1


def _dataset(cfg):
    rng = np.random.default_rng(0)
    return {"id": np.arange(N, dtype=np.int32),
            "text_tokens": rng.integers(0, cfg.vocab, (N, SEQ)).astype(np.int32),
            "hour": (np.arange(N) % 24).astype(np.int32)}


@pytest.fixture(params=["kernel", "gspmd"])
def sentiment_setup(request):
    """The paper's pipeline in miniature on the port: a 'tweets' dataset of
    fixed-width token columns and a registered classifier UDF."""
    model_udf.clear_registry()
    cfg = dataclasses.replace(get_config("paper-lm").reduced(), attn_impl="flash")
    model = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    model_udf.register_model("sentiment", model, cfg, classes=3,
                             microbatch=MICROBATCH)
    cols = _dataset(cfg)
    sess = Session(mode=request.param, device="cpu")
    sess.create_dataset("Tweets", Table(cols), dataverse="demo")
    yield sess, cols["text_tokens"]
    model_udf.clear_registry()


def test_model_udf_map_and_persist(sentiment_setup):
    sess, tokens = sentiment_setup
    df = AFrame("demo", "Tweets", session=sess)
    df["sentiment"] = df["text_tokens"].map("sentiment")
    ops.reset_dispatch_counts()
    out = df.head(8)
    assert set(out) >= {"id", "sentiment"}
    assert out["sentiment"].dtype == np.int32
    assert np.all((out["sentiment"] >= 0) & (out["sentiment"] < 3))
    # 8 rows in one microbatch: one flash call per layer
    assert ops.DISPATCH_COUNTS["flash_attention"] == 2
    # paper Input 14/15: filter on the prediction, persist
    neg = df[df["sentiment"] == 0][["id", "hour", "sentiment"]]
    saved = neg.persist("negTweets")
    got = saved.collect()
    assert np.all(got["sentiment"] == 0)
    # the persisted count equals direct application of the model
    direct = model_udf.get_udf("sentiment")(torch.from_numpy(tokens)).numpy()
    assert len(got["id"]) == len(saved) == int((direct == 0).sum())
    assert len(df[df["sentiment"] == 0]) == int((direct == 0).sum())
    np.testing.assert_array_equal(got["id"], np.nonzero(direct == 0)[0])
    # group-by on the persisted set (segment_agg in kernel mode)
    by_hour = saved.groupby("hour").agg("count")
    k, c = np.unique(got["hour"], return_counts=True)
    np.testing.assert_array_equal(by_hour["hour"], k)
    np.testing.assert_array_equal(by_hour["count"], c.astype(np.int32))


def test_udf_lazy_limit_pushdown(sentiment_setup):
    """head(2) after map runs the model on 2 rows, not the table."""
    sess, _ = sentiment_setup
    seen = []
    inner = model_udf.get_udf("sentiment")
    model_udf.register_fn("sentiment", lambda t: seen.append(len(t)) or inner(t))
    df = AFrame("demo", "Tweets", session=sess)
    out = df["text_tokens"].map("sentiment").head(2)
    opt = sess.last_optimized
    assert isinstance(opt, P.Project)
    assert isinstance(opt.children[0], P.Limit)
    assert len(out[list(out)[0]]) == 2
    assert seen == [2]


def test_unknown_udf_raises():
    model_udf.clear_registry()
    with pytest.raises(KeyError, match="no model UDF"):
        model_udf.get_udf("nope")


def test_udf_refuses_a_column_on_another_device():
    cfg = get_config("paper-lm").reduced()
    model = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    fn = model_udf.register_model("m", model, cfg, classes=3).fn
    with pytest.raises(ValueError, match="weights lie on cpu"):
        fn(torch.zeros((2, 4), dtype=torch.int32, device="meta"))
    model_udf.clear_registry()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_predictions_match_reference_session(compute, impl, monkeypatch):
    if compute == "float32":
        monkeypatch.setattr(jl, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)
    jcfg = dataclasses.replace(jget_config("paper-lm").reduced(), attn_impl=impl)
    tcfg = dataclasses.replace(get_config("paper-lm").reduced(), attn_impl=impl)
    jparams = jtf.init_lm(jax.random.key(0), jcfg)
    model = lm_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                        device="cpu")
    cols = _dataset(tcfg)

    judf.clear_registry()
    judf.register_model("sentiment", jparams, jcfg, classes=3)
    jsess = JSession()
    jsess.create_dataset("Tweets", JTable(cols), dataverse="demo")
    jdf = JFrame("demo", "Tweets", session=jsess)
    jdf["sentiment"] = jdf["text_tokens"].map("sentiment")
    want = jdf[["id", "sentiment"]].collect()
    judf.clear_registry()

    model_udf.clear_registry()
    model_udf.register_model("sentiment", model, tcfg, classes=3,
                             microbatch=MICROBATCH)
    sess = Session(mode="kernel", device="cpu")
    sess.create_dataset("Tweets", Table(cols), dataverse="demo")
    df = AFrame("demo", "Tweets", session=sess)
    df["sentiment"] = df["text_tokens"].map("sentiment")
    got = df[["id", "sentiment"]].collect()
    model_udf.clear_registry()

    np.testing.assert_array_equal(got["id"], np.asarray(want["id"]))
    assert got["sentiment"].dtype == np.int32
    if compute == "float32":
        np.testing.assert_array_equal(got["sentiment"], np.asarray(want["sentiment"]))
        return
    _, logits = jtf.lm_prefill(jparams, {"tokens": jnp.asarray(cols["text_tokens"])},
                               jcfg)
    top = np.sort(np.asarray(logits[:, -1, :3], np.float32), axis=1)
    clear = (top[:, 2] - top[:, 1]) > MARGIN
    assert clear.sum() > N // 2
    np.testing.assert_array_equal(got["sentiment"][clear],
                                  np.asarray(want["sentiment"])[clear])
