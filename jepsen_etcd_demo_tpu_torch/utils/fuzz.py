"""Random concurrent register histories for differential testing.

`gen_register_history` simulates a linearizable CAS register with an
explicit linearization point inside each op's invoke/complete window, so
its histories are linearizable by construction. `mutate_history` breaks
one (corrupts a read, or resurrects a failed cas). For the same
`random.Random` seed both functions draw exactly the numbers the JAX
package's generators draw, so both packages see the same histories.
"""

from __future__ import annotations

import random
from typing import Optional

from ..ops.op import FAIL, INFO, INVOKE, OK, Op


def gen_register_history(
    rng: random.Random,
    n_ops: int = 50,
    n_procs: int = 5,
    value_range: int = 5,
    p_read: float = 0.4,
    p_write: float = 0.35,
    p_info: float = 0.05,
    p_fail_read: float = 0.05,
    initial_value: Optional[int] = None,
) -> list[Op]:
    """Generate a valid (linearizable) single-register history."""
    value = initial_value  # the register; None == key missing
    history: list[Op] = []
    pending: dict[int, dict] = {}
    free = list(range(n_procs))
    invoked = 0

    def emit(op: Op):
        op.index = len(history)
        op.time = len(history) * 1000
        history.append(op)

    while invoked < n_ops or pending:
        choices = []
        if invoked < n_ops and free:
            choices.append("invoke")
        unlin = [p for p, d in pending.items() if not d["lin"]]
        lin = [p for p, d in pending.items() if d["lin"]]
        if unlin:
            choices.append("linearize")
            choices.append("fail_read")
        if lin:
            choices.append("complete")
        action = rng.choice(choices)

        if action == "invoke":
            proc = free.pop(rng.randrange(len(free)))
            x = rng.random()
            if x < p_read:
                f, v = "read", None
            elif x < p_read + p_write:
                f, v = "write", rng.randrange(value_range)
            else:
                f, v = "cas", (rng.randrange(value_range),
                               rng.randrange(value_range))
            emit(Op(type=INVOKE, f=f, value=v, process=proc))
            pending[proc] = {"f": f, "value": v, "lin": False, "result": None}
            invoked += 1
        elif action == "linearize":
            proc = rng.choice(unlin)
            d = pending[proc]
            if d["f"] == "read":
                d["result"] = value
            elif d["f"] == "write":
                value = d["value"]
            else:  # cas
                old, new = d["value"]
                if value == old:
                    value = new
                    d["result"] = True
                else:
                    d["result"] = False
            d["lin"] = True
        elif action == "fail_read":
            # A read that times out completes :fail (it did not happen).
            reads = [p for p in unlin if pending[p]["f"] == "read"]
            if not reads or rng.random() > p_fail_read * 4:
                continue
            proc = rng.choice(reads)
            emit(Op(type=FAIL, f="read", value=None, process=proc,
                    error="timeout"))
            del pending[proc]
            free.append(proc)
        else:  # complete
            proc = rng.choice(lin)
            d = pending.pop(proc)
            if rng.random() < p_info and d["f"] != "read":
                # Took effect but the ack was lost: indeterminate forever.
                emit(Op(type=INFO, f=d["f"], value=d["value"], process=proc,
                        error="timeout"))
                # The crashed worker comes back under a fresh process id.
                free.append(max(list(free) + list(pending) + [proc]) + 1)
                continue
            if d["f"] == "read":
                emit(Op(type=OK, f="read", value=d["result"], process=proc))
            elif d["f"] == "write":
                emit(Op(type=OK, f="write", value=d["value"], process=proc))
            else:
                status = OK if d["result"] else FAIL
                emit(Op(type=status, f="cas", value=d["value"], process=proc))
            free.append(proc)
    return history


def mutate_history(rng: random.Random, history: list[Op],
                   value_range: int = 5) -> list[Op]:
    """Corrupt a valid history so it is (probably) not linearizable."""
    out = [Op(**{**op.__dict__}) for op in history]
    candidates = [i for i, op in enumerate(out)
                  if op.type == OK and op.f == "read"]
    if candidates:
        i = rng.choice(candidates)
        old = out[i].value
        choices = [v for v in range(value_range) if v != old] + [None]
        out[i].value = rng.choice([c for c in choices if c != old])
        return out
    # No ok read to corrupt: flip a failed cas to ok.
    candidates = [i for i, op in enumerate(out)
                  if op.type == FAIL and op.f == "cas"]
    if candidates:
        out[rng.choice(candidates)].type = OK
    return out


def interleave_keyed(per_key, proc_stride: int = 1000) -> list[Op]:
    """Round-robin interleave per-key histories into one keyed op stream:
    values wrapped as ``(key, v)`` tuples, process ids moved into disjoint
    ``proc_stride``-wide ranges per key. ``per_key`` is a list of
    histories (key = position) or a dict ``{key: history}``."""
    items = list(per_key.items()) if isinstance(per_key, dict) \
        else list(enumerate(per_key))
    ops: list[Op] = []
    cursors = [0] * len(items)
    while any(c < len(h) for c, (_, h) in zip(cursors, items)):
        for i, (k, h) in enumerate(items):
            if cursors[i] < len(h):
                op = h[cursors[i]]
                cursors[i] += 1
                ops.append(Op(type=op.type, f=op.f, value=(k, op.value),
                              process=proc_stride * i + int(op.process),
                              time=op.time, error=op.error))
    return ops
