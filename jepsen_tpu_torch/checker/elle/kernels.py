"""Transactional-cycle detection: host condensation, the batched SCC
classifier on the card, host certificates.

The port's own copy of `jepsen_tpu/checker/elle/kernels.py`. The
reference delegates cycle search to the Elle JVM library
(`jepsen/src/jepsen/tests/cycle.clj:9-16`), which runs Tarjan's SCC on a
pointer graph. Here the pipeline has three stages, placed where each
sub-problem's structure lives:

  1. **Sparse condensation (host, linear time).** Every cycle — of any
     edge subset — lies entirely inside one strongly-connected component
     of the full ww|wr|rw graph, unioned with whatever additional
     precedence graphs (realtime/process, graphs.py) are in play (a path
     between two same-SCC nodes can never leave the SCC). SCC labels are
     computed in O(V+E) from COO edge lists; a valid history (no
     nontrivial SCC) short-circuits with zero device work.
  2. **Dense classification (device).** Nontrivial SCCs are small and
     need polynomial closure computations to classify the Adya anomaly
     (G0 / G1c / G-single / G2-item): boolean matrix products. SCC
     blocks are bucketed to power-of-two sizes e, batched into (B, e, e)
     stacks and classified together (`_flags_batch`, `torch.bmm` for the
     products, as the JAX package leaves its products to XLA).
  3. **Certificates (host).** BFS path reconstruction for the
     human-readable anomaly cycles, restricted to nontrivial SCCs.

SCCs larger than `max_dense` (pathological histories) are classified
host-side: G0/G1c exactly via subgraph SCC, G-single via a bounded
rw-edge probe; see `_classify_oversized`.

Every entry runs on CUDA unless the caller passes ``device="cpu"``, and
raises without a card. With a `mesh` (a `parallel.Mesh`, or a
`DeviceMesh` whose first dimension is the axis) every rank makes the
same call: the classifier's batch of SCC blocks and the closure's rows
are sharded over the ranks, and every rank gets the same result.

The port's recovery differs from the JAX package's in four deliberate
ways, so that a broken kernel or a lost card never turns into a verdict
of another path. The first three belong to the WGL ladder
(`checker/wgl.py`): the compile bucket has no rung; its final rung
reports a degraded 'unknown' and never runs the host oracle; and the
device-lost rung cannot revive a CUDA context after a sticky error. The
fourth is this module's: the JAX package's `JEPSEN_TPU_ELLE_HOST=1`
route to the numpy mirror does not exist, and a bucket whose one retry
faults again is not decided on that mirror. `_classify_batches` raises
`ClassifierFaulted`, naming the fault trail, out of `analyze_edges`, and
`checker.check_safe` reports it as a degraded 'unknown'. The mirror,
`_classify_batches_host`, stays only as the tests' oracle.
"""

from __future__ import annotations

import collections
import logging
import math

import numpy as np
import torch

from ... import parallel
from ..._platform import (CorruptDeviceResult, attest_enabled,
                          classify_backend_error, guarded_fetch,
                          maybe_corrupt, maybe_inject_fault)
from .. import abft

log = logging.getLogger(__name__)

# cap on the per-analysis G2 probe memo (see g2_verified): bounds the
# memo in long-lived checker processes chewing pathological histories
G2_CACHE_CAP = 4096

_WW, _WR, _RW = 1, 2, 4
# additional precedence graphs (graphs.py): realtime (completion
# happened-before invocation) and process (same process, next op).
# They union into the same adjacency structure as the dependency edges
# so one SCC condensation covers every cycle of every edge subset.
_PROC, _RT = 8, 16
_DEP = _WW | _WR | _RW

_BIT_NAMES = ((_WW, "ww"), (_WR, "wr"), (_RW, "rw"),
              (_PROC, "process"), (_RT, "realtime"))

# mask <-> {'ww','wr','rw',...} tables.  MASK_SETS gives the graph
# builders shared frozensets (no per-edge allocation); SET_MASK lets
# analyze_edges recover the mask by hash instead of five membership
# tests.  Frozensets hash by content, so any equal frozenset hits.
MASK_SETS = {
    m: frozenset(n for bit, n in _BIT_NAMES if m & bit)
    for m in range(32)
}
SET_MASK = {s: m for m, s in MASK_SETS.items()}


def mask_edges_to_sets(acc: dict) -> dict:
    """{(i, j): bitmask} -> {(i, j): frozenset of edge-type names}.
    The graph builders accumulate edge-type bits inline ({(i, j): mask}
    with an i != j guard, no per-edge set allocation) and convert here
    at the boundary where consumers expect {'ww', ...} sets."""
    return {k: MASK_SETS[m] for k, m in acc.items()}


def type_mask(types) -> int:
    """Edge types (frozenset/set of names, or an int mask) -> int mask."""
    if isinstance(types, int):
        return types
    if isinstance(types, frozenset):
        m = SET_MASK.get(types)
        if m is not None:
            return m
    return ((_WW if "ww" in types else 0)
            | (_WR if "wr" in types else 0)
            | (_RW if "rw" in types else 0)
            | (_PROC if "process" in types else 0)
            | (_RT if "realtime" in types else 0))


def _bucket(n: int, lo: int = 8) -> int:
    """Round up to a power of two (min 8) so recompilation is rare and
    batch members share shapes."""
    b = lo
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# SCC condensation (host, linear time)
# ---------------------------------------------------------------------------

def scc_labels(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Strongly-connected-component label per node, from COO edges."""
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components

        mat = csr_matrix((np.ones(len(src), np.int8), (src, dst)),
                         shape=(n, n))
        _, labels = connected_components(mat, directed=True,
                                         connection="strong")
        return labels.astype(np.int64)
    except ImportError:  # pragma: no cover - exercised via _tarjan test
        return _tarjan_labels(n, src, dst)


def _tarjan_labels(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Iterative Tarjan SCC — pure-Python fallback when scipy is absent."""
    adj: list[list[int]] = [[] for _ in range(n)]
    for i, j in zip(src.tolist(), dst.tolist()):
        adj[i].append(j)
    index = np.full(n, -1, np.int64)
    low = np.zeros(n, np.int64)
    on_stack = np.zeros(n, bool)
    labels = np.full(n, -1, np.int64)
    stack: list[int] = []
    counter = 0
    n_sccs = 0
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
            recursed = False
            for k in range(pi, len(adj[v])):
                w = adj[v][k]
                if index[w] == -1:
                    work[-1] = (v, k + 1)
                    work.append((w, 0))
                    recursed = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recursed:
                continue
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    labels[w] = n_sccs
                    if w == v:
                        break
                n_sccs += 1
            work.pop()
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])
    return labels


# ---------------------------------------------------------------------------
# Dense per-SCC classification (device)
# ---------------------------------------------------------------------------

# classifier calls (one per bucket attempt that reaches the products), on
# any device: a valid history makes none
LAUNCHES = 0


class ClassifierFaulted(RuntimeError):
    """A bucket's classification faulted, and its one retry faulted too.
    `kind` is the last fault's bucket (so `classify_backend_error` and
    `check_safe` place it), `faults` the whole trail."""

    def __init__(self, e: int, faults: list, exc: BaseException):
        super().__init__(
            f"elle classify: the {e}-wide bucket faulted again on its "
            f"retry (trail: {faults}); last fault: {exc}")
        self.kind = faults[-1]
        self.faults = list(faults)


def _steps(e: int) -> int:
    """Squarings that close any path of up to e nodes."""
    return max(1, math.ceil(math.log2(max(e, 2))))


def _closure(a: torch.Tensor, steps: int, res: torch.Tensor) -> torch.Tensor:
    """Transitive closure of a (B, e, e) 0/1 stack by repeated squaring,
    a <- min(a + a@a, 1), `steps` times (the JAX `lax.scan`: a fixed
    count, so no host read). Each step adds its ABFT residue to res (B,)
    int64 in place: the column checksum ones@(a@a) against (ones@a)@a,
    whose right side is a broadcast and sum (O(e^2), no product).

    Exact on any matmul precision: both operands of every product are
    0/1 (exact in TF32 and bf16), so each product entry is an integer
    <= e, and each column sum an integer <= e^2, exact in float32 up to
    e = 4096 (2^24); larger blocks sum in float64."""
    e = a.shape[-1]
    acc = torch.float32 if e * e <= 1 << 24 else torch.float64
    for _ in range(steps):
        p = torch.bmm(a, a)
        lhs = p.sum(dim=1, dtype=acc)
        ca = a.sum(dim=1, dtype=acc)
        rhs = (ca.unsqueeze(2) * a.to(acc)).sum(dim=1)
        res += (lhs.to(torch.int64) - rhs.to(torch.int64)).abs().sum(dim=1)
        a = p.add_(a).clamp_(max=1.0)
    return a


def _diag_any(x: torch.Tensor) -> torch.Tensor:
    return (torch.diagonal(x, dim1=1, dim2=2) > 0).any(dim=1)


def _flags_batch(ww: torch.Tensor, wr: torch.Tensor, rw: torch.Tensor,
                 steps: int) -> tuple:
    """Classify a batch of SCC subgraphs at once: (B, e, e) float32 0/1
    ww/wr/rw blocks -> four (B,) bool anomaly flags (G0, G1c, G-single,
    G2-item) and a (B,) int64 ABFT residue, all unfetched. The JAX
    package's `_flags_batch_fn`, with vmap's batch axis written out.

    The G-single/G2 split avoids both masking and double-counting: with
    E = the reflexive ww|wr closure, H1 = E.rw.E is "reachable using
    exactly one anti-dependency", so a true diagonal of H1 is a one-rw
    cycle (G-single). For G2-item, a simple cycle with >=2 rw edges
    visits each node once, so its rw edges have pairwise-distinct source
    nodes: with P = rw.reflexive-closure(full), a G2 cycle implies
    P[i,j] & P[j,i] for two distinct rw sources i != j.

    The flags read positivity only. E.rw is clamped to 0/1 before its
    second product (the JAX package clamps after both): the support, and
    so every flag, is the same, and every product keeps 0/1 operands.
    The residue is 0 unless a product was silently corrupted."""
    b = ww.shape[0]
    res = torch.zeros(b, dtype=torch.int64, device=ww.device)
    g0 = _diag_any(_closure(ww, steps, res))
    ec = _closure(torch.clamp(ww + wr, max=1.0), steps, res)
    g1c = _diag_any(ec)
    ec.diagonal(dim1=1, dim2=2).fill_(1.0)        # min(c_wwr + eye, 1)
    h1 = torch.bmm(torch.bmm(ec, rw).clamp_(max=1.0), ec)
    single = _diag_any(h1)
    del ec, h1
    cr = _closure(torch.clamp(ww + wr + rw, max=1.0), steps, res)
    cr.diagonal(dim1=1, dim2=2).fill_(1.0)        # max(c_full, eye)
    p = torch.bmm(rw, cr).clamp_(max=1.0)
    del cr
    q = p * p.transpose(1, 2)
    q.diagonal(dim1=1, dim2=2).zero_()            # * (1 - eye)
    g2 = (q > 0).flatten(1).any(dim=1)
    return g0, g1c, single, g2, res


def _classify_batches(buckets: dict, device=None, mesh=None) -> dict:
    """Run the batched classifier per bucket size. buckets maps
    e -> (ww[B,e,e], wr, rw) float32 numpy. Returns
    e -> (g0[B], g1c[B], single[B], g2[B]) bool numpy — per-SCC flags,
    in the caller's slot order.

    With a mesh, each bucket's B is padded with empty blocks to a
    multiple of the axis size and each rank classifies its contiguous
    block of SCC blocks on its device; the four flag rows are gathered
    to every rank.

    Attestation and recovery, as in the JAX package up to its last rung:
    the staged adjacency stacks carry host-vs-device bit-pattern digests
    (the 'elle' bitflip-injection site corrupts the first stacked block),
    and the closures' column-checksum residues must come back zero, each
    rank on its own block; flags, residues and digests come back in one
    guarded fetch (on a mesh, the gathered flags in a second). A
    classified backend fault — a `corrupt` attestation mismatch and an
    OOM included — re-stages and retries the bucket once, whole; a
    second fault raises `ClassifierFaulted` (the JAX package decides the
    bucket on its numpy mirror there; see the module docstring). On a
    mesh the ranks agree on each attempt's fault (`parallel.agree`), so
    every rank retries or raises together."""
    global LAUNCHES
    mesh, dev = parallel.resolve(mesh, device)
    mesh = mesh or parallel.local_mesh(dev)
    attest_on = attest_enabled()
    out: dict = {}
    for e, (ww, wr, rw) in sorted(buckets.items()):
        steps = _steps(e)
        b = ww.shape[0]
        faults: list = []
        for attempt in (0, 1):
            try:
                err = None
                try:
                    maybe_inject_fault("elle")
                    canon = [ww, wr, rw]
                    pad = (-b) % mesh.size
                    if pad:
                        # inputs arrive bucket-padded (analyze_edges);
                        # this only rounds the batch up to the axis
                        canon = [np.concatenate(
                            [a, np.zeros((pad, e, e), np.float32)])
                            for a in canon]
                    # corrupt after padding, so the canonical blocks the
                    # host digests cover are exactly what ships
                    staged = [maybe_corrupt("elle", canon[0])] + canon[1:]
                    blk = mesh.block(b + pad)
                    args = [torch.from_numpy(np.ascontiguousarray(a[blk]))
                            .to(dev) for a in staged]
                    # the column checksums cannot catch input corruption
                    # (a corrupted A is self-consistent under
                    # ones@(A@A) == (ones@A)@A), so the staged stacks
                    # carry digests too
                    digests = ([abft.digest_device(x) for x in args]
                               if attest_on else [])
                    LAUNCHES += 1
                    *flags, res = _flags_batch(*args, steps)
                    flags = torch.stack(flags, 1).to(torch.int32)
                    f, res, *dig = guarded_fetch(
                        lambda: [t.cpu().numpy()
                                 for t in (flags, res, *digests)],
                        site="elle classify")
                    if attest_on:
                        for d, host in zip(dig, canon):
                            abft.verify_steps("elle", d,
                                              abft.digest_host(host[blk]))
                        if res.any():
                            raise CorruptDeviceResult(
                                "elle", f"closure column-checksum residue "
                                        f"{res.max()} != 0 on "
                                        f"{int((res != 0).sum())} SCC "
                                        f"block(s)")
                except Exception as exc:  # noqa: BLE001 — agreed below
                    err = exc
                parallel.agree(mesh, err)
                if mesh.group is not None:
                    rows = parallel.all_gather_rows(mesh, flags)
                    f = guarded_fetch(lambda: rows.cpu().numpy(),
                                      site="elle classify")
                f = f[:b].astype(bool)
                out[e] = tuple(f[:, j] for j in range(4))
                break
            except RuntimeError as exc:
                kind = classify_backend_error(exc)
                if kind is None:
                    raise
                faults.append(kind)
                if attempt:
                    raise ClassifierFaulted(e, faults, exc) from exc
                log.warning("elle classify: %s fault on the %d-wide bucket "
                            "(%s); re-staging and retrying once", kind, e,
                            exc)
    return out


def _classify_batches_host(buckets: dict) -> dict:
    """The numpy mirror of the batched classifier (same contract as
    `_classify_batches`): per-SCC dense blocks -> four flag vectors.
    Exact: closure by boolean repeated squaring mirrors the device
    classifier. The JAX package's env route and last rung; in the port
    only the tests' oracle, never a path of `analyze_edges`."""
    out: dict = {}
    for e, (ww, wr, rw) in sorted(buckets.items()):
        b = ww.shape[0]
        flags = (np.zeros(b, bool), np.zeros(b, bool),
                 np.zeros(b, bool), np.zeros(b, bool))
        steps = max(1, math.ceil(math.log2(max(e, 2))))

        def closure(a):
            a = a.copy()
            for _ in range(steps):
                a = np.minimum(a + a @ a, 1.0)
            return a

        for s in range(b):
            c_ww = closure(ww[s])
            c_wwr = closure(np.minimum(ww[s] + wr[s], 1.0))
            c_full = closure(np.minimum(ww[s] + wr[s] + rw[s], 1.0))
            eye = np.eye(e)
            ec = np.minimum(c_wwr + eye, 1.0)
            h1 = np.minimum(ec @ rw[s] @ ec, 1.0)
            cr = np.maximum(c_full, eye)
            p = np.minimum(rw[s] @ cr, 1.0)
            flags[0][s] = bool(np.diag(c_ww).any())
            flags[1][s] = bool(np.diag(c_wwr).any())
            flags[2][s] = bool(np.diag(h1).any())
            flags[3][s] = bool(((p * p.T) * (1.0 - eye) > 0).any())
        out[e] = flags
    return out


def _edges_dict(src, dst, tmask) -> tuple[dict, list]:
    """COO arrays -> ({(i, j): {types}}, [rw edges])."""
    edges: dict[tuple, set] = {}
    rw_edges = []
    for i, j, t in zip((int(x) for x in src), (int(x) for x in dst),
                       (int(x) for x in tmask)):
        types = edges.setdefault((i, j), set())
        if t & _WW:
            types.add("ww")
        if t & _WR:
            types.add("wr")
        if t & _RW:
            types.add("rw")
            rw_edges.append((i, j))
    return edges, rw_edges


def _probe_g2(src, dst, tmask, probe_cap: int = 2000) -> bool:
    """Host check for a >=2-anti-dependency cycle in a (small) subgraph:
    for each rw edge (i, j), look for a return path j => i using another
    rw edge and never revisiting i mid-path. Exact when every rw edge is
    probed; past probe_cap, defers to the device's (over-approximate)
    G2 flag rather than silently dropping a possibly-real anomaly."""
    edges, rw_edges = _edges_dict(src, dst, tmask)
    for i, j in rw_edges[:probe_cap]:
        if _find_g2_path(edges, j, i, exclude_src=i):
            return True
    return len(rw_edges) > probe_cap


def _classify_oversized(nodes: np.ndarray, src, dst, tmask,
                        probe_cap: int = 2000) -> tuple:
    """Host classification for an SCC too large for a dense block:
    G0/G1c exactly via subgraph SCC; G-single/G2-item via bounded BFS
    probes over the SCC's rw edges (exact when every rw edge is probed;
    conservative — G2 inferred from cycle existence — beyond
    probe_cap). src/dst/tmask must already be the SCC's intra-component
    edges (any cycle, of any edge subset, stays within one full-graph
    SCC, so those are the only edges that matter)."""
    sub = list(zip((int(i) for i in src), (int(j) for j in dst),
                   (int(t) for t in tmask)))
    remap = {v: ix for ix, v in enumerate(nodes.tolist())}
    m = len(nodes)

    def has_subcycle(bits):
        s = np.array([remap[i] for i, j, t in sub if t & bits], np.int64)
        d = np.array([remap[j] for i, j, t in sub if t & bits], np.int64)
        if len(s) == 0:
            return False
        lab = scc_labels(m, s, d)
        return bool((np.bincount(lab, minlength=m) >= 2).any())

    g0 = has_subcycle(_WW)
    g1c = g0 or has_subcycle(_WW | _WR)
    # probes over rw edges: G-single = a ww/wr-only return path;
    # G2-item = a return path using a second anti-dependency
    sub_edges, rw_edges = _edges_dict(*zip(*sub)) if sub else ({}, [])
    single = g2 = False
    probed_all = len(rw_edges) <= probe_cap
    for i, j in rw_edges[:probe_cap]:
        if not single and find_path(sub_edges, j, i, {"ww", "wr"}):
            single = True
        if not g2 and _find_g2_path(sub_edges, j, i, exclude_src=i):
            g2 = True
        if single and g2:
            break
    if not probed_all and not (g1c or single or g2) \
            and has_subcycle(_WW | _WR | _RW):
        # a cycle exists on these edges (the union SCC is nontrivial,
        # but a *folded level* of it may be acyclic — hence the
        # explicit check); unexplained by the probes, it needs >= 2
        # anti-dependencies
        g2 = True
    return g0, g1c, single, g2


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

# Classification runs per *level*: the base level sees only dependency
# edges; each additional level folds its precedence edges into the ww
# matrix (a precedence edge behaves exactly like a write-write order for
# cycle purposes) and re-runs the SAME classifier — so the device kernel
# and its host mirror stay byte-identical, and level batches stack along
# the vmapped batch axis.  A variant anomaly (e.g. G-single-realtime) is
# reported only for SCCs where the level's flag holds and the previous
# level's does not — a cycle that *requires* the extra edge type.
# Realtime subsumes process (a process issues its next op only after the
# previous completed), hence the realtime level folds both.
_VARIANT_BASES = ("G0", "G1c", "G-single", "G2-item")
_LEVEL_SPECS = (("-process", _PROC), ("-realtime", _PROC | _RT))

_EMPTY = {"G0": False, "G1c": False, "G-single": False, "G2-item": False}
_EMPTY.update({f"{b}{s}": False
               for s, _m in _LEVEL_SPECS for b in _VARIANT_BASES})


def _fold_level(src, dst, tmask, extra: int):
    """Project a union-graph edge set onto one classification level:
    keep dependency bits, fold the level's precedence bits into ww, drop
    edges that carry neither."""
    t = (tmask & _DEP) | np.where(tmask & extra, _WW, 0).astype(tmask.dtype)
    keep = t != 0
    return src[keep], dst[keep], t[keep]


def analyze_edges(n: int, edges: dict, mesh=None,
                  max_dense: int = 4096, device=None) -> dict:
    """Classify cycles in a sparse dependency graph.

    edges: {(i, j): set of 'ww'/'wr'/'rw'}. Returns {'G0', 'G1c',
    'G-single', 'G2-item': bool, 'cycle-nodes': np int array of nodes in
    nontrivial SCCs, 'scc-labels': per-node labels or None,
    'oversized-sccs': int} following Adya's hierarchy (G-single = exactly
    one anti-dependency in the cycle, G2-item = at least two).

    device: where the classifier runs (None = the mesh's device, else
    CUDA, raising without it, even for a graph that needs no device
    work; "cpu" = the plain PyTorch path). mesh: a `parallel.Mesh` or a
    `DeviceMesh` to shard the classifier's batch over (every rank makes
    the same call and gets the same result).
    """
    mesh, dev = parallel.resolve(mesh, device)
    out = dict(_EMPTY)
    out["cycle-nodes"] = np.zeros(0, np.int64)
    out["scc-labels"] = None
    out["oversized-sccs"] = 0
    if n == 0 or not edges:
        return out

    # self-loops are cycles all by themselves (the checkers never emit
    # them, but dense-matrix adapters and direct callers can)
    self_nodes = []
    for (i, j), types in edges.items():
        if i == j:
            self_nodes.append(i)
            if "ww" in types:
                out["G0"] = out["G1c"] = True
            elif "wr" in types:
                out["G1c"] = True
            if "rw" in types:
                out["G-single"] = True
            if not (types & {"ww", "wr", "rw"}):
                # a pure precedence self-loop: an op before itself
                if "process" in types:
                    out["G0-process"] = True
                elif "realtime" in types:
                    out["G0-realtime"] = True
    plain = {(i, j): t for (i, j), t in edges.items() if i != j}
    if not plain:
        out["cycle-nodes"] = np.asarray(sorted(set(self_nodes)), np.int64)
        return out

    m = len(plain)
    src = np.fromiter((k[0] for k in plain), np.int64, count=m)
    dst = np.fromiter((k[1] for k in plain), np.int64, count=m)
    try:
        # fast path: graph builders emit the shared frozensets, which
        # hash straight back to their masks
        tmask = np.fromiter((SET_MASK[t] for t in plain.values()),
                            np.uint8, count=m)
    except (KeyError, TypeError):   # foreign set objects / masks
        tmask = np.fromiter((type_mask(t) for t in plain.values()),
                            np.uint8, count=m)

    labels = scc_labels(n, src, dst)
    sizes = np.bincount(labels)
    out["scc-labels"] = labels
    nontrivial = np.flatnonzero(sizes >= 2)
    node_in_nt = sizes[labels] >= 2
    cyc_nodes = set(np.flatnonzero(node_in_nt).tolist()) | set(self_nodes)
    out["cycle-nodes"] = np.asarray(sorted(cyc_nodes), np.int64)
    if nontrivial.size == 0:
        return out

    # local index of each nontrivial-SCC node within its SCC (stable
    # order by node id) — trivial nodes are never looked up
    nt_nodes = np.flatnonzero(node_in_nt)
    order = nt_nodes[np.argsort(labels[nt_nodes], kind="stable")]
    local = np.zeros(n, np.int64)
    seen_count: dict[int, int] = {}
    for v in order.tolist():
        lab = int(labels[v])
        c = seen_count.get(lab, 0)
        local[v] = c
        seen_count[lab] = c + 1

    # intra-SCC edges only
    esel = (labels[src] == labels[dst]) & node_in_nt[src]
    e_src, e_dst, e_t = src[esel], dst[esel], tmask[esel]
    e_lab = labels[e_src]

    # classification levels: base always; an additional level per
    # precedence graph present in some nontrivial SCC (gated on the
    # intra-SCC edges, not the whole graph — realtime edges connect
    # nearly every non-concurrent op pair, but only the ones inside an
    # SCC can participate in a cycle, so levels without any such edge
    # would just replicate the base level's device work)
    levels = [("", 0)]
    for suffix, extra in _LEVEL_SPECS:
        new_bits = extra & ~(_DEP | levels[-1][1])
        if bool((e_t & new_bits).any()):
            levels.append((suffix, extra))
    n_levels = len(levels)

    # per-SCC G2 probes, memoized by (label, level): the dense
    # distinct-rw-sources test over-approximates, so each flagged SCC is
    # host-verified with the stricter simple-path probe. LRU with a
    # size cap: a pathological history can flag thousands of SCCs
    # across several levels, and an uncapped memo would hold every
    # probe result for the whole call — evicting the oldest entries
    # only costs a re-probe if the same (label, level) is asked again.
    _g2_cache: "collections.OrderedDict[tuple, bool]" = \
        collections.OrderedDict()

    def g2_verified(lab: int, li: int) -> bool:
        key = (lab, li)
        got = _g2_cache.get(key)
        if got is None:
            emask = e_lab == lab
            got = _probe_g2(*_fold_level(
                e_src[emask], e_dst[emask], e_t[emask], levels[li][1]))
            _g2_cache[key] = got
            if len(_g2_cache) > G2_CACHE_CAP:
                _g2_cache.popitem(last=False)
        else:
            _g2_cache.move_to_end(key)
        return got

    def combine(per_level: list) -> None:
        """OR one SCC's per-level (g0, g1c, single, g2) flags into out.
        Base level reports directly; each later level reports only what
        the previous level could not explain — cycles that *require*
        that level's precedence edges."""
        for li, (suffix, _x) in enumerate(levels):
            f = per_level[li]
            if li:
                f = tuple(a and not b
                          for a, b in zip(f, per_level[li - 1]))
            for base, v in zip(_VARIANT_BASES, f):
                if v:
                    out[base + suffix] = True

    # group SCCs into power-of-two buckets; oversized ones go host-side
    by_bucket: dict[int, list] = {}
    for lab in nontrivial.tolist():
        size = int(sizes[lab])
        if size > max_dense:
            out["oversized-sccs"] += 1
            nodes = np.flatnonzero(labels == lab)
            emask = e_lab == lab
            combine([_classify_oversized(nodes, *_fold_level(
                e_src[emask], e_dst[emask], e_t[emask], extra))
                for _suffix, extra in levels])
        else:
            by_bucket.setdefault(_bucket(size), []).append(lab)

    buckets: dict[int, tuple] = {}
    for e, labs in by_bucket.items():
        b = len(labs)
        # bucket the batch axis like the SCC size, as the JAX package
        # does (its classifier is jitted per (B, e, e) shape): pad with
        # zero blocks (no edges -> no anomaly flags), sliced off by the
        # bp-strided read below
        bp = _bucket(b, lo=1)
        ww = np.zeros((bp, e, e), np.float32)
        wr = np.zeros((bp, e, e), np.float32)
        rw = np.zeros((bp, e, e), np.float32)
        aux = [np.zeros((bp, e, e), np.float32) for _ in levels[1:]]
        slot = {lab: ix for ix, lab in enumerate(labs)}
        mask = np.isin(e_lab, labs)
        for i, j, t, lab in zip(e_src[mask], e_dst[mask], e_t[mask],
                                e_lab[mask]):
            s = slot[int(lab)]
            r, c = int(local[i]), int(local[j])
            if t & _WW:
                ww[s, r, c] = 1.0
            if t & _WR:
                wr[s, r, c] = 1.0
            if t & _RW:
                rw[s, r, c] = 1.0
            for lx, (_suffix, extra) in enumerate(levels[1:]):
                if t & extra:
                    aux[lx][s, r, c] = 1.0
        # levels stack along the batch axis (one classifier call):
        # level li's ww block is ww with its precedence edges folded in
        buckets[e] = (
            np.concatenate([ww] + [np.maximum(ww, a) for a in aux]),
            np.concatenate([wr] * n_levels),
            np.concatenate([rw] * n_levels))
    if buckets:
        flags = _classify_batches(buckets, device=dev, mesh=mesh)
        for e, (f0, f1, fs, f2) in flags.items():
            labs = by_bucket[e]
            bp = _bucket(len(labs), lo=1)
            for ix, lab in enumerate(labs):
                per_level = []
                for li in range(n_levels):
                    o = li * bp + ix
                    per_level.append((
                        bool(f0[o]), bool(f1[o]), bool(fs[o]),
                        bool(f2[o]) and g2_verified(lab, li)))
                combine(per_level)
    return out


def analyze_graph(ww: np.ndarray, wr: np.ndarray, rw: np.ndarray,
                  mesh=None, device=None) -> dict:
    """Dense-matrix adapter over `analyze_edges` (kept for golden tests
    and small graphs)."""
    edges: dict[tuple, set] = {}
    for mat, typ in ((ww, "ww"), (wr, "wr"), (rw, "rw")):
        for i, j in zip(*np.nonzero(mat)):
            edges.setdefault((int(i), int(j)), set()).add(typ)
    return analyze_edges(len(ww), edges, mesh=mesh, device=device)


def transitive_closure(adj: np.ndarray, mesh=None,
                       device=None) -> np.ndarray:
    """Closure of a boolean adjacency matrix on the device by repeated
    squaring (log2(n) products of 0/1 matrices, exact on any matmul
    precision). device and mesh as in `analyze_edges`: with a mesh the
    padded matrix is sharded by rows, and each squaring gathers every
    rank's rows A and computes this rank's rows of min(A + A_r A, 1)."""
    mesh, dev = parallel.resolve(mesh, device)
    mesh = mesh or parallel.local_mesh(dev)
    n = len(adj)
    if n == 0:
        return np.zeros((0, 0), bool)
    e = -(-_bucket(n, lo=128) // mesh.size) * mesh.size
    padded = np.zeros((e, e), np.float32)
    padded[:n, :n] = adj
    a = torch.from_numpy(padded[mesh.block(e)]).to(dev)
    for _ in range(_steps(n)):
        full = parallel.all_gather_rows(mesh, a)
        a = torch.mm(a, full).add_(a).clamp_(max=1.0)
    full = parallel.all_gather_rows(mesh, a)
    return guarded_fetch(lambda: (full > 0).cpu().numpy(),
                         site="elle closure")[:n, :n]


# ---------------------------------------------------------------------------
# Host-side certificates
# ---------------------------------------------------------------------------

def find_cycle(edges: dict, start: int, allowed: set) -> list | None:
    """Host-side shortest cycle through `start` using only edge types in
    `allowed` — the human-readable certificate once the device has said a
    cycle exists. edges: {(i, j): set of edge types}."""
    from collections import deque

    adj: dict[int, list] = {}
    for (i, j), types in edges.items():
        if types & allowed:
            adj.setdefault(i, []).append(j)
    # BFS from start back to start
    q = deque([(start, [start])])
    seen = {start}
    while q:
        node, path = q.popleft()
        for nxt in adj.get(node, ()):
            if nxt == start:
                return path + [start]
            if nxt not in seen:
                seen.add(nxt)
                q.append((nxt, path + [nxt]))
    return None


def find_path(edges: dict, src: int, dst: int, allowed: set) -> list | None:
    """Shortest src -> dst path (list of nodes incl. both ends) using only
    edge types in `allowed`; [src] if src == dst."""
    from collections import deque

    if src == dst:
        return [src]
    adj: dict[int, list] = {}
    for (i, j), types in edges.items():
        if types & allowed:
            adj.setdefault(i, []).append(j)
    q = deque([(src, [src])])
    seen = {src}
    while q:
        node, path = q.popleft()
        for nxt in adj.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                q.append((nxt, path + [nxt]))
    return None


def _find_g2_path(edges: dict, src: int, dst: int,
                  exclude_src: int | None = None,
                  step_budget: int = 200_000,
                  allowed: set | None = None) -> list | None:
    """A *simple* src -> dst path over all edges that traverses at
    least one rw edge — closing a G2 cycle with the rw edge
    (exclude_src -> src), whose own rw must not be double-counted
    (rw edges out of exclude_src don't set the flag).

    Simple-path search is what makes the answer exact: a walk that
    revisits a node stitches two one-rw cycles into a figure-eight,
    which is not a simple cycle and must not count as G2 (two G-single
    cycles sharing a node are still G-single). DFS with per-path
    visited sets is exponential in the worst case, so a step budget
    guards it; on exhaustion we fall back to the polynomial
    state-BFS over (node, rw-used?) — an over-approximation that can
    mislabel a figure-eight as G2, conservative toward reporting the
    (definitely present) cyclic anomaly.

    `allowed` restricts the traversable edge types (None = all); the
    certificate layer passes it so a base-level G2 search never walks
    the precedence (process/realtime) edges of a union graph."""
    adj: dict[int, list] = {}
    for (i, j), types in edges.items():
        if allowed is not None and not (types & allowed):
            continue
        counts = "rw" in types and i != exclude_src
        adj.setdefault(i, []).append((j, counts))

    stack: list = [(src, False, (src,))]
    steps = 0
    while stack:
        steps += 1
        if steps > step_budget:
            return _g2_walk_fallback(adj, src, dst)
        node, used, path = stack.pop()
        for nxt, is_rw in adj.get(node, ()):
            u = used or is_rw
            if nxt == dst:
                if u:
                    return list(path) + [nxt]
                continue  # dst is an endpoint, never an intermediate
            if nxt == exclude_src or nxt in path:
                continue
            stack.append((nxt, u, path + (nxt,)))
    return None


def _g2_walk_fallback(adj: dict, src: int, dst: int) -> list | None:
    """Polynomial over-approximation used past the simple-path budget:
    shortest walk with >= 1 counted rw, nodes reusable."""
    from collections import deque

    q = deque([(src, False, [src])])
    seen = {(src, False)}
    while q:
        node, used, path = q.popleft()
        for nxt, is_rw in adj.get(node, ()):
            u = used or is_rw
            if nxt == dst:
                if u:
                    return path + [nxt]
                continue
            if (nxt, u) not in seen:
                seen.add((nxt, u))
                q.append((nxt, u, path + [nxt]))
    return None


def _find_path_requiring(edges: dict, src: int, dst: int,
                         allowed: set, required: str) -> list | None:
    """Shortest src -> dst walk over `allowed`-typed edges that uses at
    least one edge of type `required` — state-BFS over (node, used?).
    Certificate-quality: a node may appear twice (once per state)."""
    from collections import deque

    adj: dict[int, list] = {}
    for (i, j), types in edges.items():
        if types & allowed:
            adj.setdefault(i, []).append((j, required in types))
    q = deque([(src, False, [src])])
    seen = {(src, False)}
    while q:
        node, used, path = q.popleft()
        for nxt, is_req in adj.get(node, ()):
            u = used or is_req
            if nxt == dst:
                if u:
                    return path + [nxt]
                continue
            if (nxt, u) not in seen:
                seen.add((nxt, u))
                q.append((nxt, u, path + [nxt]))
    return None


# variant certificate searches: which precedence types the cycle may
# traverse, and which one its existence proves it needs
_VARIANT_CERT = (("-process", {"process"}, "process"),
                 ("-realtime", {"process", "realtime"}, "realtime"))


def certificates(txns: list, edges: dict, cyc: dict,
                 brief=None) -> dict:
    """Host-side certificates for whichever cycle anomalies the device
    reported. Each certificate is a node cycle (first == last) whose edge
    types actually exhibit the claimed anomaly: G0 uses only ww, G1c only
    ww/wr, G-single exactly one rw, G2-item at least two rw; the
    -process/-realtime variants additionally traverse (and, where the
    search can enforce it, require) a precedence edge of that type.

    Candidate start nodes / typed edges are restricted to nontrivial
    SCCs ('cycle-nodes' / 'scc-labels' from analyze_edges), since every
    cycle lives inside one."""
    if brief is None:
        brief = _brief_op
    out: dict = {}
    on_cycle = cyc.get("cycle-nodes")
    if on_cycle is None:
        on_cycle = np.flatnonzero(np.diag(cyc["closure"]))
    labels = cyc.get("scc-labels")
    cyc_set = set(int(i) for i in on_cycle)

    def typed_edges(t):
        return [(i, j) for (i, j), types in edges.items()
                if t in types and i in cyc_set and j in cyc_set
                and (labels is None or labels[i] == labels[j])]

    rw_edges = typed_edges("rw")

    def emit(typ, cert):
        out[typ] = [{"cycle": [brief(txns[i]) for i in cert]
                     if cert else None}]

    for typ, allowed in (("G0", {"ww"}), ("G1c", {"ww", "wr"})):
        if cyc[typ]:
            cert = None
            for i in on_cycle:
                cert = find_cycle(edges, int(i), allowed)
                if cert:
                    break
            emit(typ, cert)
    if cyc["G-single"]:
        cert = None
        for i, j in rw_edges:
            back = find_path(edges, j, i, {"ww", "wr"})
            if back is not None:
                cert = [i] + back  # i -rw-> j =ww/wr=> i
                break
        emit("G-single", cert)
    if cyc["G2-item"]:
        cert = None
        for i, j in rw_edges:
            back = _find_g2_path(edges, j, i, exclude_src=i,
                                 allowed={"ww", "wr", "rw"})
            if back is not None:
                cert = [i] + back
                break
        emit("G2-item", cert)

    for suffix, extra, req in _VARIANT_CERT:
        req_edges = None  # computed lazily, only when a variant fired
        for typ, allowed in (("G0", {"ww"}), ("G1c", {"ww", "wr"})):
            if not cyc.get(typ + suffix):
                continue
            if req_edges is None:
                req_edges = typed_edges(req)
            cert = None
            for i, j in req_edges:
                back = find_path(edges, j, i, allowed | extra)
                if back is not None:
                    cert = [i] + back  # i -req-> j =allowed=> i
                    break
            emit(typ + suffix, cert)
        if cyc.get("G-single" + suffix):
            cert = None
            for i, j in rw_edges:
                if req in edges.get((i, j), ()):
                    # the anti-dependency edge itself carries the
                    # precedence type; any ww/wr return path closes it
                    back = find_path(edges, j, i, {"ww", "wr"} | extra)
                else:
                    back = _find_path_requiring(
                        edges, j, i, {"ww", "wr"} | extra, req)
                if back is not None:
                    cert = [i] + back
                    break
            emit("G-single" + suffix, cert)
        if cyc.get("G2-item" + suffix):
            cert = fallback = None
            for i, j in rw_edges:
                back = _find_g2_path(
                    edges, j, i, exclude_src=i,
                    allowed={"ww", "wr", "rw"} | extra)
                if back is None:
                    continue
                nodes = [i] + back
                if fallback is None:
                    fallback = nodes
                if any(req in edges.get((u, v), ())
                       for u, v in zip(nodes, nodes[1:])):
                    cert = nodes
                    break
            emit("G2-item" + suffix, cert or fallback)
    return out


def _brief_op(op: dict) -> dict:
    return {"index": op.get("index"), "process": op.get("process"),
            "value": op.get("value")}