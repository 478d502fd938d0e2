"""serve: checking as a service (`serve --check`).

A long-running daemon whose HTTP API takes histories from many concurrent
tenants and checks them on the card:

  * scheduler.py - the coalescing queue: per-tenant round-robin
                   queuing, bounded in-flight admission, the
                   `serve_coalesce_ms` linger, shared bucketed launches
                   through sched.submit_corpus, and backpressure from the
                   backend supervisor (wedged -> refuse and park, drain
                   on recovery; a failed launch -> error verdicts)
  * sessions.py  - streaming sessions over the stream engine
  * daemon.py    - the HTTP surface on top of web/server.py, a store run
                   for every verdict, webhooks

The JAX package's serve/ also has a fleet (router.py, fleet.py: replicas
behind a rendezvous router), which the port does not have yet.
"""

from .scheduler import CoalescingScheduler, Rejected, ServeRequest
from .sessions import ServeSession, SessionManager, op_from_dict
from .daemon import ServeDaemon, make_serve_handler, serve_check

__all__ = [
    "CoalescingScheduler",
    "Rejected",
    "ServeDaemon",
    "ServeRequest",
    "ServeSession",
    "SessionManager",
    "make_serve_handler",
    "op_from_dict",
    "serve_check",
]
