"""Scalable Wisconsin benchmark dataset generator (paper §IV-A, Fig. 7).

Port of ``repro.data.wisconsin``: the same numpy RNG stream and the same
column recipes, so ``generate(n, seed)`` here and there give equal columns,
byte for byte. The table is built on the host; a Session places it on its
device at ``create_dataset``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.table import ColumnMeta, Table, encode_strings

_STR4 = ["AAAAxxxx", "HHHHxxxx", "OOOOxxxx", "VVVVxxxx"]


def _stringu(values: np.ndarray, prefix: str) -> np.ndarray:
    """Wisconsin template string: 7-char base-26 rendering of the value."""
    n = len(values)
    out = np.full((n, 16), ord(" "), dtype=np.uint8)
    out[:, 0] = ord(prefix)
    v = values.astype(np.int32)
    for pos in range(7):
        out[:, 7 - pos] = ord("a") + (v % 26)
        v = v // 26
    return out


def generate(num_rows: int, seed: int = 0) -> Table:
    """Generate a Wisconsin table of ``num_rows`` rows (uniform, unique keys)."""
    rng = np.random.default_rng(seed)
    unique2 = np.arange(num_rows, dtype=np.int32)
    unique1 = rng.permutation(num_rows).astype(np.int32)
    one_percent = unique1 % 100
    # string4 cycles through four templates: index the encoded rows instead
    # of encoding num_rows Python strings
    string4 = encode_strings(_STR4).numpy()[np.arange(num_rows) % 4]

    cols: dict[str, np.ndarray] = {
        "unique1": unique1,
        "unique2": unique2,
        "two": unique1 % 2,
        "four": unique1 % 4,
        "ten": unique1 % 10,
        "twenty": unique1 % 20,
        "onePercent": one_percent,
        "tenPercent": unique1 % 10,
        "twentyPercent": unique1 % 5,
        "fiftyPercent": unique1 % 2,
        "unique3": unique1.copy(),
        "evenOnePercent": one_percent * 2,
        "oddOnePercent": one_percent * 2 + 1,
        "stringu1": _stringu(unique1, "A"),
        "stringu2": _stringu(unique2, "B"),
        "string4": string4,
    }

    def m(lo, hi, distinct, **kw):
        return ColumnMeta(np.dtype(np.int32), lo, hi, distinct, **kw)

    meta = {
        "unique1": m(0, num_rows - 1, num_rows),
        "unique2": m(0, num_rows - 1, num_rows, sorted_ascending=True),
        "two": m(0, 1, 2),
        "four": m(0, 3, 4),
        "ten": m(0, 9, 10),
        "twenty": m(0, 19, 20),
        "onePercent": m(0, 99, 100),
        "tenPercent": m(0, 9, 10),
        "twentyPercent": m(0, 4, 5),
        "fiftyPercent": m(0, 1, 2),
        "unique3": m(0, num_rows - 1, num_rows),
        "evenOnePercent": m(0, 198, 100),
        "oddOnePercent": m(1, 199, 100),
        "stringu1": ColumnMeta(np.dtype(np.uint8), is_string=True, distinct=num_rows),
        "stringu2": ColumnMeta(np.dtype(np.uint8), is_string=True, distinct=num_rows),
        "string4": ColumnMeta(np.dtype(np.uint8), is_string=True, distinct=4),
    }
    return Table({k: torch.from_numpy(v) for k, v in cols.items()}, meta)
