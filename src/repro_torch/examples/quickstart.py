"""Quickstart: the AFrame user experience (paper Figs. 2-3), on the port.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import sys

from repro_torch.core.frame import AFrame
from repro_torch.data import wisconsin
from repro_torch.engine.session import Session


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # -- "CREATE DATASET ... / LOAD DATASET" (paper Fig. 1) --------------------
    sess = Session(device=args.device)
    table = wisconsin.generate(100_000, seed=0)
    sess.create_dataset("TrainingData", table, dataverse="demo",
                        indexes=["onePercent"], primary="unique2")

    # -- In [2]: initializing an AFrame object is O(1): data is *managed* ------
    df = AFrame("demo", "TrainingData", session=sess)

    # -- lazy expressions (paper Inputs 4-5): nothing executes yet -------------
    evens = df[df["two"] == 0]
    small = evens[["unique1", "ten", "stringu1"]]

    # -- Inputs 7-8: inspect the incrementally-built query ---------------------
    print("underlying query:")
    print(" ", small.query)
    print("optimized form:")
    print(" ", small.optimized_query)

    # -- Input 6: an ACTION triggers evaluation (LIMIT pushed into the plan) ---
    # (columns by name: the reference's jitted results come back so ordered)
    print("\nhead(3):")
    for k, v in sorted(small.head(3).items()):
        print(f"  {k:10s} {v[:3]}")

    # -- aggregates / groupby / sort --------------------------------------------
    print("\nlen(df)            =", len(df))
    print("df['unique1'].max() =", df["unique1"].max())
    g = df.groupby("twenty")["four"].agg("max")
    print("groupby('twenty')['four'].max() ->",
          dict(zip(g["twenty"][:5].tolist(), g["max_four"][:5].tolist())))
    top = df.sort_values("unique1", ascending=False).head(3)
    print("top-3 by unique1    =", top["unique1"].tolist())

    # -- index-accelerated range count (paper expression 11) --------------------
    n = len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 19)])
    print("range count (index-only query) =", n)
    print("  executed as:", sess.last_optimized.to_sql())

    # -- persist (paper Input 15) ------------------------------------------------
    saved = small.persist("EvenRows")
    print("\npersisted demo.EvenRows; len =", len(saved))
    print("plan cache:", sess.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
