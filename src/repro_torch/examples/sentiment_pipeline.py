"""The paper's end-to-end story (Figs. 2-6) on the port: train a small
classifier locally, register it as an engine UDF, apply it to a managed
dataset at scale, and persist the negative-prediction subset for root-cause
analysis.

The sklearn pipeline of Fig. 4 becomes an LM classification head; the
"LiveTweets" feed becomes an ingesting dataset of fixed-width token columns.

Run:  PYTHONPATH=src python -m repro_torch.examples.sentiment_pipeline [--device cpu]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.frame import AFrame
from repro_torch.device import resolve_device
from repro_torch.engine.ingest import Feed
from repro_torch.engine.session import Session
from repro_torch.engine.table import Table
from repro_torch.models.optim import OptimConfig, init_opt_state
from repro_torch.models.registry import get_api
from repro_torch.models.steps import make_train_step
from repro_torch.udf import model_udf


def main(argv=None, model=None) -> int:
    """``model``: the untrained weights (default: seeded random ones from
    the port's init, seed 0)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    cfg = get_config("paper-lm").reduced()

    # -- Fig. 4: "train a model locally" ----------------------------------------
    # synthetic sentiment task: class = f(token prefix); train the tiny LM a
    # few steps so the head is non-random (the *pipeline* is the point, not
    # accuracy)
    print("== training the local model (Fig. 4) ==")
    if model is None:
        model = get_api(cfg).init(cfg, torch.Generator(device=device).manual_seed(0))
    opt = init_opt_state(model)
    step = make_train_step(cfg, OptimConfig(lr=1e-3, total_steps=50))
    for i in range(20):
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)).to(device)}
        model, opt, m = step(model, opt, batch)
    print(f"   final LM loss: {float(m['loss']):.3f}")

    # -- "drop it into the engine as a UDF" --------------------------------------
    model_udf.register_model("sentiment", model, cfg, classes=3)
    print("   registered UDF 'sentiment' (3 classes)")

    # -- Fig. 1/2: a live dataset fed by an ingestion feed ------------------------
    sess = Session(device=device)
    n0 = 2_000
    tokens = rng.integers(0, cfg.vocab, (n0, 16)).astype(np.int32)
    sess.create_dataset("LiveTweets", Table({
        "id": np.arange(n0, dtype=np.int32),
        "text_tokens": tokens,
        "hour": (np.arange(n0) % 24).astype(np.int32),
    }), dataverse="demo")
    feed = Feed(sess, "LiveTweets", "demo", flush_rows=512)
    # a continuously-maintained dashboard aggregate: refreshed incrementally
    # from each flush's delta batch, never recomputed from scratch
    dash = AFrame("demo", "LiveTweets", session=sess)
    sess.create_view("tweets_by_hour", dash.groupby("hour").agg_plan("count"))
    for _ in range(2):  # two arriving batches
        m_new = 512
        feed.push({"id": np.arange(m_new, dtype=np.int32) + 10_000,
                   "text_tokens": rng.integers(0, cfg.vocab, (m_new, 16)).astype(np.int32),
                   "hour": rng.integers(0, 24, m_new).astype(np.int32)})
    print(f"== live feed: {feed.stats} ==")
    by_hour_live = sess.read_view("tweets_by_hour")
    print(f"   dashboard view: {int(by_hour_live['count'].sum())} tweets "
          f"across {len(by_hour_live['hour'])} hours (no query ran)")

    # -- Fig. 5: apply the model to the text column ------------------------------
    df = AFrame("demo", "LiveTweets", session=sess)
    df["sentiment"] = df["text_tokens"].map("sentiment")
    print("== applying the UDF (Fig. 5) ==")
    print("   query:", df.query[:120], "...")
    sample = df.head(5)
    print("   sample predictions:", sample["sentiment"])

    # -- Fig. 6: negative subset, persisted ----------------------------------------
    neg = df[df["sentiment"] == 0][["id", "hour", "sentiment"]]
    saved = neg.persist("negTweets")
    print(f"== persisted demo.negTweets: {len(saved)} rows ==")
    by_hour = saved.groupby("hour").agg("count")
    busiest = int(by_hour["hour"][np.argmax(by_hour["count"])])
    print(f"   busiest negative hour: {busiest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
