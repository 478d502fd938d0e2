"""Random concurrent histories for differential testing.

`gen_register_history` simulates a linearizable CAS register with an
explicit linearization point inside each op's invoke/complete window, so
its histories are linearizable by construction. `mutate_history` breaks
one (corrupts a read, or resurrects a failed cas). The set, queue and
multi-register generators simulate their object the same way
(`_gen_history`), and `mutate_family_history` breaks one of theirs.
`gen_append_txns` runs list-append transactions serially against a store
with unique append values, so its histories are anomaly-free by
construction, and `mutate_append_txns` breaks one read. For the same `random.Random` seed
every generator draws exactly the numbers the JAX package's draws, so
both packages see the same histories.
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


# -- other model families (models/gset.py, queues.py, multi_register.py) --
#
# Same construction as gen_register_history: simulate the object with an
# explicit linearization point inside each op's invoke/complete window,
# so the produced history is linearizable by construction. The family
# plugs in as three callbacks:
#   choose(rng)                 -> (f, invoke_value)
#   linearize(sim, f, value)    -> (ok, result)  [mutates sim; ok=False
#                                  completes as :fail — e.g. empty dequeue]
#   may_info(f)                 -> op may take effect yet never complete
#                                  (dequeues may NOT: the encoder rejects
#                                  indeterminate dequeues as unencodable)


def _gen_history(rng: random.Random, n_ops: int, n_procs: int,
                 choose, linearize, may_info, sim,
                 p_info: float = 0.05) -> list[Op]:
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
        if lin:
            choices.append("complete")
        action = rng.choice(choices)

        if action == "invoke":
            proc = free.pop(rng.randrange(len(free)))
            f, v = choose(rng)
            emit(Op(type=INVOKE, f=f, value=v, process=proc))
            pending[proc] = {"f": f, "value": v, "lin": False}
            invoked += 1
        elif action == "linearize":
            proc = rng.choice(unlin)
            d = pending[proc]
            d["ok"], d["result"] = linearize(sim, d["f"], d["value"])
            d["lin"] = True
        else:  # complete
            proc = rng.choice(lin)
            d = pending.pop(proc)
            if (d["ok"] and may_info(d["f"]) and rng.random() < p_info):
                emit(Op(type=INFO, f=d["f"], value=d["value"], process=proc,
                        error="timeout"))
                # Reincarnate the worker as a fresh process id, like jepsen.
                free.append(max(list(free) + list(pending) + [proc]) + 1)
                continue
            emit(Op(type=OK if d["ok"] else FAIL, f=d["f"],
                    value=d["result"], process=proc))
            free.append(proc)
    return history


def gen_gset_history(rng: random.Random, n_ops: int = 40, n_procs: int = 5,
                     value_range: int = 5, p_info: float = 0.05) -> list[Op]:
    """Valid grow-only-set history: concurrent adds + exact-set reads."""
    def choose(rng):
        if rng.random() < 0.4:
            return "read", None
        return "add", rng.randrange(value_range)

    def linearize(sim, f, v):
        if f == "add":
            sim.add(v)
            return True, v
        return True, sorted(sim)  # read observes the current set

    return _gen_history(rng, n_ops, n_procs, choose, linearize,
                        lambda f: f == "add", set(), p_info)


def gen_queue_history(rng: random.Random, n_ops: int = 20, n_procs: int = 4,
                      fifo: bool = True, value_range: int = 5,
                      max_enqueues: int = 10,
                      p_info: float = 0.05) -> list[Op]:
    """Valid queue history. fifo=True dequeues the head (FIFOQueue model,
    values drawn from 0..value_range-1, at most max_enqueues of them);
    fifo=False dequeues a RANDOM queued element with unique values
    (UnorderedQueue model)."""
    counter = iter(range(10_000))
    budget = {"enq": max_enqueues if fifo else 31}

    def choose(rng):
        if budget["enq"] > 0 and rng.random() < 0.55:
            budget["enq"] -= 1
            v = rng.randrange(value_range) if fifo else next(counter)
            return "enqueue", v
        return "dequeue", None

    def linearize(sim, f, v):
        if f == "enqueue":
            sim.append(v)
            return True, v
        if not sim:
            return False, None  # empty dequeue fails (did not take effect)
        i = 0 if fifo else rng.randrange(len(sim))
        return True, sim.pop(i)

    return _gen_history(rng, n_ops, n_procs, choose, linearize,
                        lambda f: f == "enqueue", [], p_info)


def gen_multireg_history(rng: random.Random, n_ops: int = 40,
                         n_procs: int = 5, n_registers: int = 3,
                         value_range: int = 5,
                         p_info: float = 0.05) -> list[Op]:
    """Valid multi-register history: (index, value) writes, indexed reads."""
    def choose(rng):
        i = rng.randrange(n_registers)
        if rng.random() < 0.45:
            return "read", (i, None)
        return "write", (i, rng.randrange(value_range))

    def linearize(sim, f, v):
        if f == "write":
            i, val = v
            sim[i] = val
            return True, v
        i = v[0]
        return True, (i, sim.get(i))  # read observes register i (None=NIL)

    return _gen_history(rng, n_ops, n_procs, choose, linearize,
                        lambda f: f == "write", {}, p_info)


def mutate_family_history(rng: random.Random, history: list[Op],
                          family: str, value_range: int = 5) -> list[Op]:
    """Corrupt a valid family history so it is (probably) not linearizable:
    gset — flip an element's membership in an ok read; fifo-queue — swap
    two dequeued values (reorder) or corrupt one; unordered-queue —
    duplicate a delivered value; multi-register — corrupt an ok read."""
    out = [Op(**{**op.__dict__}) for op in history]
    if family == "gset":
        reads = [i for i, op in enumerate(out)
                 if op.type == OK and op.f == "read"]
        if reads:
            i = rng.choice(reads)
            s = set(out[i].value)
            v = rng.randrange(value_range)
            out[i].value = sorted(s ^ {v})
        return out
    if family in ("fifo-queue", "unordered-queue"):
        deqs = [i for i, op in enumerate(out)
                if op.type == OK and op.f == "dequeue"]
        if family == "fifo-queue" and len(deqs) >= 2:
            a, b = rng.sample(deqs, 2)
            out[a].value, out[b].value = out[b].value, out[a].value
        elif deqs:
            i = rng.choice(deqs)
            others = [out[j].value for j in deqs if j != i]
            out[i].value = rng.choice(others) if others else (
                (out[i].value + 1) % 31)
        return out
    if family == "multi-register":
        reads = [i for i, op in enumerate(out)
                 if op.type == OK and op.f == "read"]
        if reads:
            i = rng.choice(reads)
            reg, old = out[i].value
            choices = [v for v in range(value_range) if v != old] + [None]
            out[i].value = (reg, rng.choice(
                [c for c in choices if c != old]))
        return out
    raise ValueError(f"unknown family {family!r}")


def gen_append_txns(rng: random.Random, n_txns: int = 50,
                    n_keys: int = 8, max_len: int = 3,
                    p_read: float = 0.5, first_key: int = 0) -> list[tuple]:
    """Serializable-by-construction list-append txn corpus (the elle
    workload shape, checkers/elle.py): txns execute SERIALLY against a
    per-key list store with unique append values, so every read is the
    true list at its serialization point — anomaly-free by
    construction. Returns ("ok", [micro-op, ...]) tuples; use
    `append_txn_ops` to expand them into an invoke/completion history
    and `mutate_append_txns` to break one."""
    store: dict = {}
    counters: dict = {}
    txns = []
    for _ in range(n_txns):
        mops = []
        for _ in range(1 + rng.randrange(max_len)):
            k = f"k{first_key + rng.randrange(n_keys)}"
            if rng.random() < p_read:
                mops.append(("r", k, tuple(store.get(k, ()))))
            else:
                counters[k] = counters.get(k, 0) + 1
                v = counters[k]
                store[k] = tuple(store.get(k, ())) + (v,)
                mops.append(("append", k, v))
        txns.append(("ok", mops))
    return txns


def append_txn_ops(txns) -> list[Op]:
    """Expand ("ok"|"fail"|"info", [mops]) txn tuples into the
    invoke/completion Op history the elle checkers pair — one process
    per txn, reads blanked to None on the invoke."""
    h = []
    for p, (typ, mops) in enumerate(txns):
        inv = [(m[0], m[1], None) if m[0] == "r" else m for m in mops]
        h.append(Op(type=INVOKE, f="txn", value=inv, process=p))
        h.append(Op(type=typ, f="txn",
                    value=mops if typ == "ok" else inv, process=p))
    return h


def mutate_append_txns(rng: random.Random, txns) -> list[tuple]:
    """Corrupt a valid append-txn corpus so it is (probably) anomalous:
    drop an element from an observed list (lost-append / rw cycles),
    duplicate one, or swap two (incompatible-order / G0). Differential
    tests only require the routes to AGREE, so mutants that stay valid
    are fine."""
    out = [(typ, [tuple(m) for m in mops]) for typ, mops in txns]
    reads = [(i, j) for i, (typ, mops) in enumerate(out)
             for j, m in enumerate(mops)
             if typ == "ok" and m[0] == "r" and len(m[2]) >= 1]
    if not reads:
        return out
    i, j = reads[rng.randrange(len(reads))]
    typ, mops = out[i]
    k, vs = mops[j][1], list(mops[j][2])
    mode = rng.randrange(3)
    if mode == 0 and len(vs) >= 1:
        vs.pop(rng.randrange(len(vs)))            # lost element
    elif mode == 1:
        vs.insert(rng.randrange(len(vs) + 1),
                  vs[rng.randrange(len(vs))])     # duplicate
    elif len(vs) >= 2:
        a, b = rng.sample(range(len(vs)), 2)
        vs[a], vs[b] = vs[b], vs[a]               # reorder
    else:
        vs = vs + vs                              # duplicate the singleton
    mops[j] = ("r", k, tuple(vs))
    return out
