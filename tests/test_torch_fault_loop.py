"""The port's fault-tolerant training loop (ROADMAP A10.3) against the JAX
reference on the CPU: tests/test_runtime.py's loop checks replayed on
``repro_torch.runtime.fault``, and both packages' loops driven side by side
with the same failure schedules.

* The toy functional step of tests/test_runtime.py (a scalar pulled to the
  batch's mean; its batch holds a float32 leaf, so "nan" fires): equal
  events and log steps, losses within 1e-6 relative (float32 arithmetic,
  the same operations).
* A reduced qwen3 through each package's train step on the same weights
  (the reference's jitted ``make_train_step`` on its pytree, the port's
  in-place step on ``from_jax``'s model) with a node failure, a straggler
  and a "nan" on an int-only batch (which the reference leaves untouched,
  so neither package records it): equal events and log steps, losses
  within ``test_torch_train.LOSS_TOL["float32"]`` (both computing in
  float32: the same arithmetic in other orders).

The reference's checkpoints here are synchronous: its restore picks the
latest step before it waits for the save in flight, so an async save
still being written when a rollback comes would make it roll back further
than the port (which waits first) — a race, not a schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import optim as joptim
from repro.models import steps as jsteps
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime.fault import FailureInjector as JFailureInjector
from repro.runtime.fault import FaultTolerantLoop as JFaultTolerantLoop
from repro.runtime.fault import TrainLoopConfig as JTrainLoopConfig
from repro_torch.launch.train import ModelState
from repro_torch.models import convert, optim, steps
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import (FailureInjector, FaultTolerantLoop,
                                       TrainLoopConfig, TreeState)
from test_torch_families import cfgs, ref_params, set_dtype
from test_torch_train import LOSS_TOL


def _toy_step(xp):
    def train_step(params, opt, batch):
        g = 2 * (params - batch["x"].mean())
        params = params - 0.1 * g
        return params, opt, {"loss": ((params - batch["x"].mean()) ** 2).mean()}
    return train_step


def _toy_data(xp):
    def data_factory(start):
        def gen():
            while True:
                yield {"x": xp(np.full((4,), 3.0, np.float32))}
        return gen()
    return data_factory


TOY_SCHEDULE = {7: "node", 12: "nan", 15: "straggler"}


# -- tests/test_runtime.py:39-75 replayed ----------------------------------------

def test_fault_loop_recovers_and_converges(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3)
    loop = FaultTolerantLoop(_toy_step(torch), cm, TrainLoopConfig(ckpt_every=5),
                             FailureInjector(dict(TOY_SCHEDULE)))
    p, o, log = loop.run(torch.tensor(10.0), {}, _toy_data(torch.from_numpy), 25)
    assert len(loop.events) == 3
    assert float(log[-1][1]) < 1e-3
    assert log[-1][0] == 24


def test_fault_loop_gives_up_on_persistent_failure(tmp_path):
    def bad_step(params, opt, batch):
        return params, opt, {"loss": torch.tensor(float("nan"))}

    def data_factory(start):
        def gen():
            while True:
                yield {"x": torch.ones(2)}
        return gen()

    cm = CheckpointManager(tmp_path)
    loop = FaultTolerantLoop(bad_step, cm, TrainLoopConfig(max_retries_per_step=2))
    with pytest.raises(RuntimeError, match="giving up"):
        loop.run(torch.tensor(1.0), {}, data_factory, 5)
    assert [s for s, _ in loop.events] == [0, 0, 0]


# -- side by side with the reference ----------------------------------------------

def test_toy_loop_matches_reference(tmp_path):
    """The functional toy step through both loops: a float leaf's "nan"
    records the event in both, and the rollbacks land on the same steps."""
    jloop = JFaultTolerantLoop(_toy_step(jnp), JCheckpointManager(
        tmp_path / "ref", keep=3, async_save=False), JTrainLoopConfig(ckpt_every=5),
        JFailureInjector(dict(TOY_SCHEDULE)))
    _, _, jlog = jloop.run(jnp.asarray(10.0), {}, _toy_data(jnp.asarray), 25)
    loop = FaultTolerantLoop(_toy_step(torch), CheckpointManager(tmp_path / "port", keep=3),
                             TrainLoopConfig(ckpt_every=5),
                             FailureInjector(dict(TOY_SCHEDULE)), TreeState())
    p, _, log = loop.run(torch.tensor(10.0), {}, _toy_data(torch.from_numpy), 25)
    assert loop.events == jloop.events
    assert any("FloatingPointError" in e for _, e in loop.events)
    assert [s for s, _ in log] == [s for s, _ in jlog]
    np.testing.assert_allclose([l for _, l in log], [l for _, l in jlog], rtol=1e-6)
    assert p.dtype == torch.float32 and p.shape == ()


def test_nan_leaves_bf16_and_int_leaves_untouched(tmp_path):
    """The reference poisons only leaves numpy counts as floating: a bf16
    leaf (an encdec batch's frames) and int tokens pass as they are, so
    the step runs and no event is recorded, in both packages."""
    def step(xp):
        def train_step(params, opt, batch):
            return params, opt, {"loss": batch["f"].astype(jnp.float32).sum()
                                 if xp is jnp else batch["f"].float().sum()}
        return train_step

    def data(make):
        def factory(start):
            def gen():
                while True:
                    yield make()
            return gen()
        return factory

    jloop = JFaultTolerantLoop(step(jnp), JCheckpointManager(tmp_path / "ref", async_save=False),
                               injector=JFailureInjector({1: "nan"}))
    _, _, jlog = jloop.run(jnp.asarray(0.0), {}, data(lambda: {
        "f": jnp.ones(3, jnp.bfloat16), "t": jnp.arange(3, dtype=jnp.int32)}), 3)
    loop = FaultTolerantLoop(step(torch), CheckpointManager(tmp_path / "port"),
                             injector=FailureInjector({1: "nan"}))
    _, _, log = loop.run(torch.tensor(0.0), {}, data(lambda: {
        "f": torch.ones(3, dtype=torch.bfloat16),
        "t": torch.arange(3, dtype=torch.int32)}), 3)
    assert loop.events == jloop.events == []
    assert log == [(s, float(l)) for s, l in jlog] == [(0, 3.0), (1, 3.0), (2, 3.0)]


SCHEDULE = {2: "node", 4: "nan", 6: "straggler"}
STEPS, CKPT_EVERY, B, S = 8, 3, 2, 24


def test_model_loop_matches_reference(tmp_path, monkeypatch):
    """A reduced qwen3 trained 8 steps through both loops from the same
    weights, checkpoints every 3 steps, a node failure at 2, a "nan" on
    the int-only batch of 4 (no event: the reference's rule) and a
    straggler at 6 (rolls back to 6's checkpoint): equal events and log
    steps, losses within LOSS_TOL["float32"], each re-run step's loss
    equal to its first run's, and the same checkpoints kept."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = cfgs("qwen3-1.7b")
    params = ref_params(jcfg)
    opt_cfg = dict(warmup_steps=2, total_steps=STEPS)

    def batches(to):
        def factory(start):
            def gen():
                i = start
                while True:
                    rng = np.random.default_rng(777 + i)
                    yield {"tokens": to(rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32))}
                    i += 1
            return gen()
        return factory

    jstep = jax.jit(jsteps.make_train_step(jcfg, joptim.OptimConfig(**opt_cfg)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jloop = JFaultTolerantLoop(jstep, JCheckpointManager(tmp_path / "ref", async_save=False),
                               JTrainLoopConfig(ckpt_every=CKPT_EVERY),
                               JFailureInjector(dict(SCHEDULE)))
    _, _, jlog = jloop.run(jparams, joptim.init_opt_state(jparams),
                           batches(jnp.asarray), STEPS)

    model = convert.from_jax(params, tcfg, device="cpu")
    opt = optim.init_opt_state(model)
    loop = FaultTolerantLoop(steps.make_train_step(tcfg, optim.OptimConfig(**opt_cfg)),
                             CheckpointManager(tmp_path / "port"),
                             TrainLoopConfig(ckpt_every=CKPT_EVERY),
                             FailureInjector(dict(SCHEDULE)), ModelState(tcfg))
    model, opt, log = loop.run(model, opt, batches(torch.from_numpy), STEPS)

    assert loop.events == jloop.events == [
        (2, "NodeFailure: injected node failure at step 2"),
        (6, "Straggler: injected straggler at step 6")]
    assert [s for s, _ in log] == [s for s, _ in jlog] == \
        [0, 1, 0, 1, 2, 3, 4, 5, 6, 7]
    np.testing.assert_allclose([l for _, l in log], [l for _, l in jlog],
                               rtol=LOSS_TOL["float32"])
    # a re-run step repeats its first run's loss exactly (restored state,
    # the same batch)
    first = dict(reversed(log))
    assert all(l == first[s] for s, l in log)
    assert int(opt["step"]) == STEPS
    assert sorted(p.name for p in (tmp_path / "port").glob("step_*")) == \
        sorted(p.name for p in (tmp_path / "ref").glob("step_*"))
