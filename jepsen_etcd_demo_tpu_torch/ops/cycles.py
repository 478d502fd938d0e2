"""Cycle detection over dependency graphs: elle's closure engine.

A graph arrives as a boolean adjacency matrix on the host (numpy). Node i
lies on a cycle iff i reaches itself through at least one edge, which the
closure answers by repeated squaring in the boolean semiring, as f32
matrix products clamped to {0, 1} (exact: every sum stays below 2^24):

    R_1 = A,  R_{2k} = min(R_k + R_k @ R_k, 1),  cyc[i] = R+[i, i]

The squaring loop stops at the first round that changes nothing, and
after ceil(log2 n_pad) rounds at most. Routes, chosen by
limits().elle_mode (or a `route` argument):

  * dense: the whole graph as one padded matrix, `torch.matmul`;
  * batched: a corpus of graphs in {2^k, 1.5*2^k} padded-size buckets,
    each bucket closed in one batched product (`torch.matmul` over a
    stacked batch) until every graph is at its fixpoint;
  * tiled: the blocked work-list closure of ops/cycles_tiled.py, whose
    sparse rounds run the hand-written accumulate kernel;
  * auto: dense up to elle_dense_max_nodes; above it the graph splits
    into weak components (a cycle never spans two), closed batched
    (small) or tiled (big);
  * oracle: a graph whose padded matrix would exceed elle_cell_budget
    takes the exact host Tarjan/SCC closure; nothing goes to the card.

The route never changes an answer: the closure's fixpoint is unique.
`counts` records how many graphs took each route since the last
`reset_counts()`, and how many tiled rounds ran sparse or dense; tests
and chip_smoke.py read it. Cycle-presence probes fetch only the diagonal
(O(N) bytes); `reach_and_cycles` fetches the whole closure for callers
that need it (witnesses).

Entry points take `device=None`, meaning cuda (they raise without a
card); `device="cpu"` runs every product on the host.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from .limits import limits

# Graphs per route, and tiled closure rounds per kind, since the last
# reset_counts().
counts = {"graphs_dense": 0, "graphs_batched": 0, "graphs_tiled": 0,
          "graphs_oracle": 0, "tiled_rounds_sparse": 0,
          "tiled_rounds_dense": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def _pad_to(n: int, mult: int = 128) -> int:
    return max(mult, (n + mult - 1) // mult * mult)


def _bucket(n: int, floor: int) -> int:
    """{2^k, 1.5*2^k} growth from `floor`."""
    r = max(1, floor)
    while r < n:
        if r + r // 2 >= n:
            return r + r // 2
        r *= 2
    return r


def _closure_steps(n_pad: int) -> int:
    # ceil(log2(n_pad)) squarings bound the longest simple path.
    return max(1, int(np.ceil(np.log2(n_pad))))


def squaring_closure(adj: torch.Tensor) -> tuple[torch.Tensor, int]:
    """adj f32[..., n, n] (0/1) -> (R+ f32[..., n, n], rounds): rounds of
    R = min(R + R @ R, 1) until one changes nothing in any graph of the
    batch, at most ceil(log2 n). A graph at its fixpoint stays there, so
    batching never changes a graph's closure."""
    steps = _closure_steps(adj.shape[-1])
    r, rounds = adj, 0
    while rounds < steps:
        r2 = torch.clamp_max(r + r @ r, 1.0)
        rounds += 1
        changed = bool((r2 != r).any())
        r = r2
        if not changed:
            break
    return r, rounds


def _padded(adj: np.ndarray, n_pad: int, dev: torch.device) -> torch.Tensor:
    n = adj.shape[0]
    a = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=dev)
    a[:n, :n] = torch.from_numpy(np.ascontiguousarray(adj)).to(dev)
    return a


def _route(route: str | None = None) -> str:
    if route is not None:
        return route
    return {0: "auto", 1: "dense", 2: "tiled"}[limits().elle_mode]


def _cells_ok(n_pad: int) -> bool:
    return n_pad * n_pad <= limits().elle_cell_budget


def _tiled_cells_ok(n: int) -> bool:
    """The budget applied to the padded size the tiled closure allocates
    (its tile, not 128)."""
    from .cycles_tiled import _tile

    return _cells_ok(_pad_to(n, _tile()))


def reach_and_cycles(adj: np.ndarray, route: str | None = None, device=None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """adj bool[N, N] (edge i->j) -> (reach bool[N, N], paths of at least
    one edge; cycle mask bool[N]), on the host. "tiled" (or "auto" above
    elle_dense_max_nodes) takes the tiled closure, otherwise one dense
    matrix; past elle_cell_budget the exact host closure."""
    dev = resolve_device(device)
    n = adj.shape[0]
    if n == 0:
        return np.zeros((0, 0), bool), np.zeros((0,), bool)
    r = _route(route)
    n_pad = _pad_to(n)
    if not _cells_ok(n_pad):
        counts["graphs_oracle"] += 1
        return _host_reach_and_cycles(adj)
    if r == "tiled" or (r == "auto" and n > limits().elle_dense_max_nodes):
        from . import cycles_tiled

        return cycles_tiled.reach_and_cycles_tiled(adj, dev)
    counts["graphs_dense"] += 1
    R, _rounds = squaring_closure(_padded(adj, n_pad, dev))
    reach = (R[:n, :n] > 0.5).cpu().numpy()
    return reach, reach.diagonal().copy()


def cycle_mask(adj: np.ndarray, route: str | None = None, device=None,
               timings: dict | None = None) -> np.ndarray:
    """bool[N]: which nodes lie on a cycle. Fetches only the diagonal;
    on the auto route a graph above elle_dense_max_nodes splits into weak
    components (batched small, tiled big, host SCC past the budget).

    When `timings` is a dict, it gains the host-clock seconds of the
    component split ("weak_components_s") and of the closures with their
    fetches ("closure_s", the rest of the call), added to what it holds."""
    t0 = time.perf_counter()
    split = {"weak_components_s": 0.0}
    out = _cycle_mask(adj, route, device, split)
    if timings is not None:
        wc = split["weak_components_s"]
        timings["weak_components_s"] = (
            timings.get("weak_components_s", 0.0) + wc)
        timings["closure_s"] = (timings.get("closure_s", 0.0)
                                + time.perf_counter() - t0 - wc)
    return out


def _cycle_mask(adj: np.ndarray, route: str | None, device,
                split: dict) -> np.ndarray:
    dev = resolve_device(device)
    n = adj.shape[0]
    if n == 0:
        return np.zeros((0,), bool)
    r = _route(route)
    n_pad = _pad_to(n)
    if r == "dense" or (r == "auto"
                        and n <= limits().elle_dense_max_nodes):
        if not _cells_ok(n_pad):
            counts["graphs_oracle"] += 1
            return _host_cycle_mask(adj)
        counts["graphs_dense"] += 1
        R, _rounds = squaring_closure(_padded(adj, n_pad, dev))
        return (torch.diagonal(R)[:n] > 0.5).cpu().numpy()
    if r == "tiled":
        from . import cycles_tiled

        if not _tiled_cells_ok(n):
            counts["graphs_oracle"] += 1
            return _host_cycle_mask(adj)
        return cycles_tiled.cycle_mask_tiled(adj, dev)
    return _cycle_mask_decomposed(adj, dev, split)


def _cycle_mask_decomposed(adj: np.ndarray, dev: torch.device,
                           split: dict | None = None) -> np.ndarray:
    """Weak components closed independently: a singleton is on a cycle
    iff it has a self-edge, small components close batched, big ones
    tiled (or on the host past the cell budget). The split's seconds go
    to split["weak_components_s"] when `split` is given."""
    n = adj.shape[0]
    out = np.zeros((n,), bool)
    small: list[np.ndarray] = []
    small_idx: list[np.ndarray] = []
    dense_max = limits().elle_dense_max_nodes
    t0 = time.perf_counter()
    comps = weak_components(adj)
    if split is not None:
        split["weak_components_s"] += time.perf_counter() - t0
    for comp in comps:
        if comp.size == 1:
            out[comp[0]] = bool(adj[comp[0], comp[0]])
            continue
        sub = adj[np.ix_(comp, comp)]
        if comp.size <= dense_max:
            small.append(sub)
            small_idx.append(comp)
            continue
        from . import cycles_tiled

        if not _tiled_cells_ok(comp.size):
            counts["graphs_oracle"] += 1
            out[comp] = _host_cycle_mask(sub)
            continue
        out[comp] = cycles_tiled.cycle_mask_tiled(sub, dev)
    if small:
        for comp, cyc in zip(small_idx, cycle_masks_batch(small, dev)):
            out[comp] = cyc
    return out


def has_cycle(adj: np.ndarray, device=None) -> bool:
    return bool(cycle_mask(adj, device=device).any())


# -- batched corpus-of-graphs closure -----------------------------------------

def _batched_launches(adjs: dict):
    """Group graphs ({index: adj}, all inside the cell budget) into
    {2^k, 1.5*2^k} padded-size buckets, bucket each group's batch axis
    from elle_batch_floor, and chunk under stack_element_budget. Yields
    (indices, stacked f32[b, n_pad, n_pad] on the host)."""
    lim = limits()
    buckets: dict[int, list[int]] = {}
    for i, a in adjs.items():
        buckets.setdefault(_bucket(_pad_to(a.shape[0]), floor=128),
                           []).append(i)
    for n_pad in sorted(buckets):
        idxs = buckets[n_pad]
        chunk = max(1, lim.stack_element_budget // (n_pad * n_pad))
        for c0 in range(0, len(idxs), chunk):
            part = idxs[c0:c0 + chunk]
            b = max(min(_bucket(len(part), floor=lim.elle_batch_floor),
                        chunk), len(part))
            stacked = np.zeros((b, n_pad, n_pad), np.float32)
            for j, i in enumerate(part):
                a = adjs[i]
                stacked[j, :a.shape[0], :a.shape[0]] = a
            yield part, stacked


def batchable(n: int) -> bool:
    """True when same-size graphs should close in one batched launch:
    auto or dense route, inside the dense crossover and the cell budget.
    Past those each graph goes through cycle_mask on its own."""
    return (_route() != "tiled" and n <= limits().elle_dense_max_nodes
            and _cells_ok(_bucket(_pad_to(n), floor=128)))


def _batch_partition(adjs):
    """(indices inside the cell budget at bucket size, indices past it)."""
    ok, over = [], []
    for i, a in enumerate(adjs):
        (ok if _cells_ok(_bucket(_pad_to(a.shape[0]), floor=128))
         else over).append(i)
    return ok, over


def _closed_batches(adjs, dev: torch.device):
    """(part, closure f32[b, n_pad, n_pad] on dev) per batched launch of
    the graphs inside the budget; counts them batched."""
    ok, _over = _batch_partition(adjs)
    for part, stacked in _batched_launches({i: adjs[i] for i in ok}):
        R, _rounds = squaring_closure(torch.from_numpy(stacked).to(dev))
        counts["graphs_batched"] += len(part)
        yield part, R


def cycle_masks_batch(adjs, device=None) -> list[np.ndarray]:
    """Per-graph cycle masks (bool[N_i]) of a corpus of graphs, in
    batched launches with diagonal-only fetches; graphs past the cell
    budget take the host oracle."""
    dev = resolve_device(device)
    out: list = [None] * len(adjs)
    for i in _batch_partition(adjs)[1]:
        counts["graphs_oracle"] += 1
        out[i] = _host_cycle_mask(adjs[i])
    for part, R in _closed_batches(adjs, dev):
        diag = (torch.diagonal(R, dim1=-2, dim2=-1) > 0.5).cpu().numpy()
        for j, i in enumerate(part):
            out[i] = diag[j, :adjs[i].shape[0]]
    return out


def reach_and_cycles_batch(adjs, device=None
                           ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(reach, cycle mask) per graph of a corpus, in the same batched
    launches; graphs past the cell budget take the host closure."""
    dev = resolve_device(device)
    out: list = [None] * len(adjs)
    for i in _batch_partition(adjs)[1]:
        counts["graphs_oracle"] += 1
        out[i] = _host_reach_and_cycles(adjs[i])
    for part, R in _closed_batches(adjs, dev):
        fetched = (R > 0.5).cpu().numpy()
        for j, i in enumerate(part):
            n = adjs[i].shape[0]
            reach = fetched[j, :n, :n]
            out[i] = (reach, reach.diagonal().copy())
    return out


# -- component decomposition --------------------------------------------------

def weak_components(adj: np.ndarray) -> list[np.ndarray]:
    """Weakly connected components (host union-find with path halving
    over the edge list). Index arrays, each sorted, ordered by their
    smallest node: a pure function of the graph, so routing through
    components is deterministic."""
    n = adj.shape[0]
    parent = np.arange(n, dtype=np.intp)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]   # path halving
            x = parent[x]
        return x

    for a, b in zip(*np.nonzero(adj)):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots: dict[int, list[int]] = {}
    for i in range(n):
        roots.setdefault(find(i), []).append(i)
    return [np.asarray(v, dtype=np.intp) for _, v in sorted(roots.items())]


def reach_pairs(adj: np.ndarray, pairs, device=None) -> np.ndarray:
    """Reachability answers for (src, dst) queries, bool[len(pairs)],
    without the whole closure: pairs in different weak components are
    unreachable, and each component with a query is closed once (routed
    as reach_and_cycles)."""
    dev = resolve_device(device)
    pairs = list(pairs)
    out = np.zeros((len(pairs),), bool)
    if not pairs:
        return out
    n = adj.shape[0]
    if n <= limits().elle_dense_max_nodes and _route() != "tiled":
        reach, _ = reach_and_cycles(adj, device=dev)
        for i, (s, d) in enumerate(pairs):
            out[i] = reach[s, d]
        return out
    comps = weak_components(adj)
    label = np.zeros((n,), np.intp)
    for ci, comp in enumerate(comps):
        label[comp] = ci
    by_comp: dict[int, list[int]] = {}
    for i, (s, d) in enumerate(pairs):
        if label[s] == label[d]:
            by_comp.setdefault(int(label[s]), []).append(i)
    for ci, idxs in sorted(by_comp.items()):
        comp = comps[ci]
        pos = {int(v): j for j, v in enumerate(comp)}
        reach, _ = reach_and_cycles(adj[np.ix_(comp, comp)], device=dev)
        for i in idxs:
            s, d = pairs[i]
            out[i] = reach[pos[int(s)], pos[int(d)]]
    return out


# -- host closures (past the cell budget; exact by construction) -------------

def _host_cycle_mask(adj: np.ndarray) -> np.ndarray:
    """Exact cycle mask by iterative Tarjan SCC: a node is on a cycle iff
    its SCC has two or more nodes or it has a self-edge. O(N + E)."""
    n = adj.shape[0]
    succ = [np.flatnonzero(adj[i]) for i in range(n)]
    index = np.full(n, -1, np.intp)
    low = np.zeros(n, np.intp)
    on_stack = np.zeros(n, bool)
    stack: list[int] = []
    out = np.zeros(n, bool)
    counter = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            for j in range(pi, len(succ[v])):
                w = int(succ[v][j])
                if index[w] == -1:
                    work[-1] = (v, j + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    out[scc] = True
                elif adj[v, v]:
                    out[v] = True
    return out


def _host_reach_and_cycles(adj: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Exact closure by a BFS from every node, O(N * E) at worst."""
    n = adj.shape[0]
    succ = [np.flatnonzero(adj[i]) for i in range(n)]
    reach = np.zeros((n, n), bool)
    for s in range(n):
        q = deque(int(x) for x in succ[s])
        seen = np.zeros(n, bool)
        seen[succ[s]] = True
        while q:
            v = q.popleft()
            reach[s, v] = True
            for w in succ[v]:
                w = int(w)
                if not seen[w]:
                    seen[w] = True
                    q.append(w)
    return reach, reach.diagonal().copy()


# -- witnesses ----------------------------------------------------------------

def bfs_path(adj: np.ndarray, src: int, dst: int) -> list[int] | None:
    """Shortest path src -> dst (both ends included) by BFS; None if dst
    is unreachable."""
    if src == dst:
        return [src]
    parent = {src: None}
    q = deque([src])
    while q:
        v = q.popleft()
        for s in np.flatnonzero(adj[v]):
            s = int(s)
            if s in parent:
                continue
            parent[s] = v
            if s == dst:
                path = [s]
                while parent[path[-1]] is not None:
                    path.append(parent[path[-1]])
                return path[::-1]
            q.append(s)
    return None


def extract_cycle(adj: np.ndarray, reach: np.ndarray,
                  cycles: np.ndarray) -> list[int]:
    """One explicit cycle (first == last) through the first cycle node,
    from the closure: BFS from a successor that reaches it back to it."""
    starts = np.flatnonzero(cycles)
    if starts.size == 0:
        return []
    c = int(starts[0])
    for s in np.flatnonzero(adj[c]):
        s = int(s)
        if s == c:
            return [c, c]
        if reach[s, c]:
            back = bfs_path(adj, s, c)
            assert back is not None, "closure says s reaches c"
            return [c] + back
    raise AssertionError("cycle node has no successor on its cycle")


def extract_cycle_any(adj: np.ndarray, cycles: np.ndarray) -> list[int]:
    """One explicit cycle from the cycle mask alone (no closure): BFS from
    each successor of the first cycle node back to it."""
    starts = np.flatnonzero(cycles)
    if starts.size == 0:
        return []
    c = int(starts[0])
    for s in np.flatnonzero(adj[c]):
        s = int(s)
        if s == c:
            return [c, c]
        back = bfs_path(adj, s, c)
        if back is not None:
            return [c] + back
    raise AssertionError("cycle node has no successor on its cycle")
