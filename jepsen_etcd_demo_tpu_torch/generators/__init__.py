"""Operation-scheduling generator combinators.

The equivalent of jepsen.generator as the reference demo uses it
(src/jepsen/etcdemo.clj:120-125,134-144,168-174; set.clj:47-49): `mix`,
`limit`, `stagger`, `time-limit`, `phases`, `nemesis`, `clients`, `log`,
`sleep`, `once`, `cycle`, and jepsen.independent's
`concurrent-generator`.

Generators are small state machines advanced only by the runner's one
event loop, and every random draw comes from one seeded
`random.Random`, so a seed fixes the schedule. The draws are the JAX
package's, one for one: the same seed gives the same ops.

Protocol: `Gen.next_for(ctx)` returns
  * an `Op`          - dispatch it now (consumes the op),
  * `Pending(wake)`  - nothing for this asker until `wake` (ns; None =
                       until some other event changes the world),
  * `None`           - exhausted for this asker, forever.

`ctx` carries the asking process ("nemesis" or a client int), the
relative time in ns and the shared rng. Time is injected, never read
from the wall clock, so generators run under a scripted clock in tests.
"""

from .core import (  # noqa: F401
    Gen, GenContext, Pending, NEMESIS,
    fn_gen, lift, Mix, Limit, Once, TimeLimit, Stagger, Sleep, Log, Seq,
    Cycle, Repeat, OnNemesis, OnClients, Phases,
    mix, limit, once, time_limit, stagger, sleep, log, seq, cycle, repeat,
    each_thread,
    nemesis_gen, clients_gen, phases,
)
from .independent import ConcurrentGenerator, concurrent_generator, tuple_gen  # noqa: F401
