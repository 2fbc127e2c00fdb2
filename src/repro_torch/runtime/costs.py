"""The cost counters active in the process, and the two hooks through
which work the dispatcher cannot see reports to them.

A counter (``launch/hlocost.py``'s ``CostModel``) registers itself in
``COUNTERS`` while it is active. Two kinds of call are charged as a whole
instead of by the ops they dispatch:

  * a hand kernel's call (``kernels/ops.py``): on the card a ctypes
    launch, which the dispatcher never sees, on "meta" empty outputs, on
    the CPU the plain version; each counter is charged the kernel
    module's cost, so a call costs the same on every device;
  * a collective (``engine/distributed.py``): booked by kind, parts and
    bytes; the ops that merge the parts on the one device are not
    counted as elementwise work.

With no counter active each hook is the bare call.
"""
from __future__ import annotations

import contextlib

COUNTERS: list = []


def opaque():
    """A block whose ops the active counters do not count: each
    counter's ``opaque()`` entered for the block."""
    stack = contextlib.ExitStack()
    for c in COUNTERS:
        stack.enter_context(c.opaque())
    return stack


def kernel(name: str, cost, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a kernel wrapper's call, with every active
    counter charged ``cost()`` for kernel ``name`` and shown only the
    call's outputs, not the ops inside it."""
    if not COUNTERS:
        return fn(*args, **kwargs)
    with opaque():
        out = fn(*args, **kwargs)
    work = cost()
    for c in COUNTERS:
        c.kernel(name, work, out)
    return out


def collective(kind: str, parts: int, read: int, merge, received):
    """``merge()``, booked by every active counter as one ``kind``
    collective over ``parts`` devices: each reads ``read`` bytes of its
    part and receives ``received(result)`` bytes."""
    if not COUNTERS:
        return merge()
    with opaque():
        out = merge()
    for c in COUNTERS:
        c.collective(kind, parts, read, received(out), out)
    return out
