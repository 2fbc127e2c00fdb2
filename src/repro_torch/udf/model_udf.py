"""Model UDFs: models of the zoo applied inside query programs (port of
``repro.udf.model_udf``, paper §III-C).

The paper drops a locally trained sklearn pipeline into AsterixDB as a UDF
and applies it per row. Here the registered UDF is a language model from
``repro_torch.models``; applied to a fixed-width token column inside a
query, it runs batched on the session's device, in microbatches of rows.

    register_model("sentiment", model, cfg, classes=3)    # Fig. 4's `dump`
    df["sentiment"] = df["text_tokens"].map("sentiment")  # Fig. 5
    df[df["sentiment"] == 0].persist("negTweets")         # Fig. 6
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

_REGISTRY: dict[str, "ModelHandle"] = {}


@dataclasses.dataclass
class ModelHandle:
    name: str
    fn: Optional[Callable] = None  # (tokens (n, seq) int32) -> (n,) predictions

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        return _REGISTRY[self.name].fn(tokens)


def register_fn(name: str, fn: Callable) -> ModelHandle:
    """Register a raw (n, seq) -> (n,) torch function as a UDF."""
    h = ModelHandle(name, fn)
    _REGISTRY[name] = h
    return h


def register_model(name: str, model, cfg, *, classes: Optional[int] = None,
                   microbatch: Optional[int] = None) -> ModelHandle:
    """Register an LM from the zoo as a classification UDF.

    Prediction = argmax over the first ``classes`` logits at the last token
    (the sentiment-head convention of the example pipeline), as int32.
    ``microbatch`` bounds activation memory: rows run in chunks of that
    many (rows are independent, so the last chunk may be shorter). The
    model runs where its weights lie; a token column on another device is
    refused, never copied."""
    from repro_torch.models.registry import get_api

    api = get_api(cfg)
    device = next(model.parameters()).device

    @torch.no_grad()
    def predict(tokens: torch.Tensor) -> torch.Tensor:
        if tokens.device != device:
            raise ValueError(f"model UDF {name!r}: its weights lie on {device}, "
                             f"the column on {tokens.device}")
        tokens = tokens.to(torch.int32)
        step = microbatch or max(tokens.shape[0], 1)
        outs = []
        for s0 in range(0, tokens.shape[0], step):
            _, logits = api.prefill(model, {"tokens": tokens[s0:s0 + step]},
                                    cfg, cache=False)
            head = logits[:, -1, :]
            if classes is not None:
                head = head[:, :classes]
            outs.append(torch.argmax(head, dim=-1).to(torch.int32))
        if not outs:
            return torch.zeros(0, dtype=torch.int32, device=device)
        return torch.cat(outs)

    return register_fn(name, predict)


def get_udf(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"no model UDF {name!r} registered "
                       f"(known: {sorted(_REGISTRY)})")
    return _REGISTRY[name].fn


def clear_registry() -> None:
    _REGISTRY.clear()
