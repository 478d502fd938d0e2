"""run_test: setup -> interpret generators -> teardown -> check -> store.

The structure of jepsen.core/run! (SURVEY.md §3.1):
  1. OS + DB setup per node, concurrently (src/jepsen/etcdemo.clj:161,34-55)
  2. worker tasks - `concurrency` clients and one nemesis - take ops from
     the generator, invoke them, and record invoke/completion pairs
  3. DB teardown per node (:57-60), log collection (db/LogFiles, :62-64)
  4. checker.check over the recorded history (:115-119,165-167), on the
     device the test's checkers were built for; with check_mode "stream"
     most of it happens during step 2 (stream/), and with fail_fast a
     falsified run ends early
  5. everything persisted under <store>/<name>/<timestamp>/

Worker/process model: each worker runs one logical process. A process
whose op completes :info has crashed and never invokes again; the worker
carries on as process + concurrency with a freshly opened client. This is
what keeps :info ops open forever in the history.
"""

from __future__ import annotations

import asyncio
import logging
import random
import selectors
import time
from typing import Any, Optional

from ..clients.base import Client
from ..control.runner import runner_for
from ..generators.core import (NEMESIS, SECOND, Gen, GenContext, Pending,
                               Phases)
from ..nemesis.base import Nemesis
from ..obs import health
from ..ops.op import INVOKE, Op
from .history import HistoryRecorder

log = logging.getLogger(__name__)


class _RunState:
    """Shared state of the interpreter loop (one event loop, no locks)."""

    def __init__(self, recorder: HistoryRecorder, rng: random.Random):
        self.recorder = recorder
        self.rng = rng
        self.in_flight = 0
        # Made inside the run's event loop and dropped with the run.
        self.wake = asyncio.Condition()

    async def notify(self):
        async with self.wake:
            self.wake.notify_all()


async def _close_quietly(client: Client, test: dict) -> None:
    try:
        await client.close(test)
    except Exception:
        pass


async def _worker(test: dict, gen: Gen, state: _RunState,
                  worker_id: int, concurrency: int,
                  client_proto: Optional[Client], nemesis: Optional[Nemesis]):
    """One worker: ask the generator, invoke, record, until exhausted."""
    is_nemesis = worker_id < 0
    process: Any = NEMESIS if is_nemesis else worker_id
    client: Optional[Client] = None
    nodes = test["nodes"]

    try:
        while True:
            ctx = GenContext(state.recorder.now(), process, state.rng, test)
            out = gen.next_for(ctx)
            if out is None:
                # Final: while a phase barrier is pending, Phases answers
                # Pending, not None.
                return
            if isinstance(out, Pending):
                await _wait(state, out.wake, ctx.time)
                _maybe_open_barrier(gen, state)
                continue
            op: Op = out
            if op.type == "log":
                log.info("%s", op.value)
                continue
            op.process = process
            state.in_flight += 1
            state.recorder.append(op)
            try:
                if is_nemesis:
                    completion = await nemesis.invoke(test, op)
                else:
                    if client is None:
                        node = nodes[int(process) % len(nodes)]
                        client = await client_proto.open(test, node)
                    completion = await client.invoke(test, op)
            except Exception as e:  # a client bug or an unexpected edge
                log.exception("invoke crashed for %s", op)
                completion = Op(type="info", f=op.f, value=op.value,
                                process=process, error=f"crash: {e}")
            finally:
                state.in_flight -= 1
            completion.process = process
            state.recorder.append(completion)
            if not is_nemesis and completion.type == "info":
                # The process crashed (indeterminate op): reincarnate.
                if client is not None:
                    await _close_quietly(client, test)
                    client = None
                process = int(process) + concurrency
            _maybe_open_barrier(gen, state)
            await state.notify()
    finally:
        if client is not None:
            await _close_quietly(client, test)


async def _wait(state: _RunState, wake: Optional[int], now: int):
    """Sleep until `wake` (relative ns) or until some completion/barrier
    changes the world."""
    if wake is not None:
        delay = max(0.0, (wake - now) / SECOND)
        await asyncio.sleep(min(delay, 0.5) if delay else 0.001)
        return
    async with state.wake:
        try:
            await asyncio.wait_for(state.wake.wait(), timeout=0.2)
        except asyncio.TimeoutError:
            pass


def event_loop() -> asyncio.AbstractEventLoop:
    """The event loop `test` runs a test in: a selector loop over
    select(2), whose timeouts resolve to a microsecond. The default loop
    waits in epoll, which rounds every timeout up to a whole millisecond,
    so each op a schedule releases costs one more millisecond tick and a
    host with coarse wakeups records far below the requested rate (a 3000
    Hz schedule: 6,571 ops in 6 s on the H100 machine's host, 12,137 over
    select). The waits themselves (_wait) are the JAX package's."""
    return asyncio.SelectorEventLoop(selectors.SelectSelector())


def _maybe_open_barrier(gen: Gen, state: _RunState):
    """Phase barrier: open the next phase once nothing is in flight
    (jepsen: every worker finishes phase N before N+1 starts)."""
    if isinstance(gen, Phases) and gen.barrier_pending() \
            and state.in_flight == 0:
        gen.barrier_done()


async def interpret_generators(test: dict, recorder: HistoryRecorder,
                               stop_check=None) -> list[Op]:
    """Run the generator interpreter loop to exhaustion; return the
    history.

    `stop_check` (--fail-fast in stream mode) is polled every 50 ms; once
    it returns true the workers are cancelled and the history recorded so
    far is returned: the streaming check has already falsified the run."""
    concurrency = int(test.get("concurrency", 10))
    # Publish the resolved value: generators that map a reincarnated
    # process back to its thread read it.
    test["concurrency"] = concurrency
    state = _RunState(recorder, random.Random(test.get("seed", 0)))
    gen = test["generator"]
    client_proto = test.get("client")
    nemesis = test.get("nemesis")
    tasks = [asyncio.create_task(
        _worker(test, gen, state, i, concurrency, client_proto, nemesis))
        for i in range(concurrency)]
    if nemesis is not None:
        tasks.append(asyncio.create_task(
            _worker(test, gen, state, -1, concurrency, None, nemesis)))
    if stop_check is None:
        await asyncio.gather(*tasks)
        return recorder.history
    stopped = False

    async def watch():
        nonlocal stopped
        while True:
            await asyncio.sleep(0.05)
            if stop_check():
                stopped = True
                break
            # A worker that crashed must end the run now, as gather()
            # would in post mode, not when the generator runs out.
            if any(t.done() and not t.cancelled()
                   and t.exception() is not None for t in tasks):
                break
        # Cancel until every worker is done: one cancel() can be lost
        # when it races the wait_for timeout inside _wait.
        while any(not t.done() for t in tasks):
            for t in tasks:
                if not t.done():
                    t.cancel()
            await asyncio.sleep(0.05)

    watcher = asyncio.create_task(watch())
    try:
        results = await asyncio.gather(*tasks, return_exceptions=True)
    finally:
        watcher.cancel()
        try:
            await watcher
        except asyncio.CancelledError:
            pass
    for r in results:
        if isinstance(r, BaseException) \
                and not isinstance(r, asyncio.CancelledError):
            if not stopped:
                raise r
            # Workers torn down mid-await may raise after the abort; the
            # verdict is decided already.
            log.warning("worker error during fail-fast abort: %r", r)
    if stopped:
        log.info("=== fail-fast: the streaming check falsified the run; "
                 "aborting with %d history entries", len(recorder.history))
    return recorder.history


async def _setup_run(test: dict
                     ) -> tuple[Optional[Client], Optional[Nemesis]]:
    """Node, client data-plane (Client.setup!, set.clj:15-16) and nemesis
    setup."""
    await _setup_nodes(test)
    client_proto: Optional[Client] = test.get("client")
    if client_proto is not None:
        c = await client_proto.open(test, test["nodes"][0])
        await c.setup(test)
        await c.close(test)
    nemesis: Optional[Nemesis] = test.get("nemesis")
    if nemesis is not None:
        await nemesis.setup(test)
    return client_proto, nemesis


async def _teardown_run(test: dict, client_proto: Optional[Client],
                        nemesis: Optional[Nemesis], store_dir=None) -> None:
    """Nemesis heal -> client data-plane teardown -> node teardown (with
    log download when a store dir is given)."""
    if nemesis is not None:
        await nemesis.teardown(test)
    if client_proto is not None:
        c = await client_proto.open(test, test["nodes"][0])
        await c.teardown(test)
        await c.close(test)
    await _teardown_nodes(test, store_dir)


async def _setup_nodes(test: dict):
    db = test.get("db")
    os_setup = test.get("os_setup")

    async def setup_one(node):
        r = runner_for(test, node)
        if os_setup is not None:
            await os_setup(r, node)
        if db is not None:
            await db.setup(test, r, node)

    await asyncio.gather(*(setup_one(n) for n in test["nodes"]))


async def _teardown_nodes(test: dict, store_dir=None):
    db = test.get("db")
    if db is None:
        return

    async def teardown_one(node):
        r = runner_for(test, node)
        if store_dir is not None:
            for remote in db.log_files(test, node):
                local = store_dir / f"{node}-{remote.rsplit('/', 1)[-1]}"
                await r.download(remote, str(local))
        await db.teardown(test, r, node)

    await asyncio.gather(*(teardown_one(n) for n in test["nodes"]))


async def run_test(test: dict) -> dict:
    """Execute a full test; return the result map (with "valid"). With a
    `store_root`, the run directory gets test.json, history.jsonl,
    results.json, jepsen.log and what the checkers write."""
    from ..store import Store

    store = None
    log_handler = None
    if test.get("store_root") is not None:
        store = Store(test["store_root"]).new_run(test.get("name", "test"))
        log_handler = _attach_file_log(store.path)
    try:
        return await _run_test_inner(test, store)
    finally:
        # A later run in the same process (--test-count > 1) must not
        # append to this run's jepsen.log.
        if log_handler is not None:
            _detach_file_log(log_handler)


async def _run_test_inner(test: dict, store) -> dict:
    log.info("=== %s: setting up %d nodes", test.get("name"),
             len(test["nodes"]))
    t0 = time.monotonic()
    client_proto, nemesis = await _setup_run(test)
    log.info("=== running workload")
    # Stream mode: the recorder's listener feeds a session that encodes
    # and sweeps the stable prefix on its own thread while the workers
    # run; the check phase then drains and finalizes it. A checker tree
    # that cannot stream is checked post-hoc.
    session = None
    fail_fast = bool(test.get("fail_fast"))
    if str(test.get("check_mode") or "post").lower() == "stream":
        from ..stream import session_for_test

        session = session_for_test(test)
        if session is None:
            log.info("=== check-mode stream unavailable for this checker; "
                     "checking post-hoc")
        elif fail_fast:
            # Keys the workload has left would otherwise keep their last
            # partial chunk unswept until the drain.
            session.enable_eager_flush()
    recorder = HistoryRecorder(listener=session.feed if session else None)

    def stop_check():
        if session.falsified():
            session.aborted = True
            return True
        return False

    try:
        history = await interpret_generators(
            test, recorder,
            stop_check=stop_check if session and fail_fast else None)
    finally:
        if session is not None:
            # The overlap ends here; the drain goes on on the session's
            # thread under the teardown.
            session.finish_input()
        await _teardown_run(test, client_proto, nemesis,
                            store.path if store else None)
    run_s = time.monotonic() - t0
    log.info("=== run complete: %d history entries in %.1fs; checking",
             len(history), run_s)
    checker = test.get("checker")
    opts = {"store_dir": str(store.path)} if store else {}
    # Backend health (obs/health.py): a finished check is a success.
    supervisor = health.get_supervisor()
    drain_s = 0.0
    if session is not None:
        # Valid streamed verdicts settle their keys in the checkers;
        # invalid ones are checked again for their witness.
        t1 = time.monotonic()
        stream_results = session.finalize()
        drain_s = time.monotonic() - t1
        if stream_results is not None:
            opts["stream_results"] = stream_results
    result = (checker.check(test, history, opts)
              if checker is not None else {"valid": True})
    if checker is not None:
        supervisor.note_ok(source="runner.check")
    result.setdefault("op_count",
                      sum(1 for o in history if o.type == INVOKE))
    result["run_seconds"] = run_s
    result["check_mode"] = "stream" if session is not None else "post"
    if session is not None:
        result["stream"] = {**session.stats(), "drain_s": drain_s}
    if store is not None:
        store.write_run(test, history, result)
        log.info("=== stored run at %s", store.path)
    log.info("=== valid: %s", result.get("valid"))
    return result


def _attach_file_log(store_path) -> logging.Handler:
    """Tee the framework log into the run directory's jepsen.log, at INFO
    whatever the embedding program's root level. Detach with
    _detach_file_log."""
    root = logging.getLogger()
    handler = logging.FileHandler(store_path / "jepsen.log")
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    handler.setLevel(logging.INFO)
    handler._prev_root_level = root.level  # restored on detach
    if root.getEffectiveLevel() > logging.INFO:
        root.setLevel(logging.INFO)
    root.addHandler(handler)
    return handler


def _detach_file_log(handler: logging.Handler) -> None:
    root = logging.getLogger()
    root.removeHandler(handler)
    root.setLevel(handler._prev_root_level)
    handler.close()
