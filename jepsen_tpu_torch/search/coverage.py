"""Schedule-coverage signals over simulated histories.

What "coverage" means for a distributed-systems scenario is *which
synchronization patterns the schedule actually exercised* (AccelSync's
synchronization-coverage insight, arXiv 2605.07881), not which code
ran. Three signal families, each reduced to a set of stable 64-bit
coverage *bits*:

  overlap   fault-window x operation-phase bitmap: for every client op
            that completed, which nemesis fault kinds were active over
            its in-flight interval, classified per kind as
            'throughout' (active at invoke and completion),
            'ended-during', 'began-during', or 'within' (the window
            opened AND closed while the op was in flight). Ops in
            flight while >= 2 kinds were simultaneously active also
            set a pairwise (kind, kind, f) bit — conjunction faults
            are their own coverage dimension. Per (kind, f) the COUNT
            of overlapped ops also sets cumulative log2-bucket bits,
            so a schedule overlapping more of a rare op phase is
            coverage-novel over one that grazed it — the gradient the
            search climbs toward narrow phases.
  kgram     interleaving digests: hashed k-grams (k=3) of each
            process's (f, type) op ordering, bucketed into a bounded
            space. Process ids never enter the hash, so digests are
            stable under op-id renumbering.
  adj       nemesis/op adjacency: for each nemesis event, the f of the
            last client event before it and the first after it.

Bits are BLAKE2b-64 hashes of canonical key tuples — no registry, no
ordering dependence, stable across runs, processes, and platforms. A
corpus-wide CoverageMap accumulates bits; novelty is a set difference,
and the whole map has a stable binary encoding (sorted u64 big-endian)
so two encodings are byte-comparable.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Iterable

# nemesis f -> (fault kind, activates?) — the fault-kind vocabulary of
# nemesis/combined.py's packages (partition / kill / pause / clock);
# tests/test_search.py pins this table against the packages' perf sets
# so a new package can't silently fall out of coverage.
START_F = {"kill": "kill", "start-partition": "partition",
           "pause": "pause", "bump-clock": "clock",
           "strobe-clock": "clock"}
STOP_F = {"start": "kill", "stop-partition": "partition",
          "resume": "pause", "reset-clock": "clock"}

KGRAM_K = 3
KGRAM_SPACE = 4096  # k-gram buckets; bounded so digests stay compact

_SEP = b"\x1f"


def _bit(*parts) -> int:
    """One stable 64-bit coverage bit from a canonical key tuple."""
    payload = _SEP.join(str(p).encode("utf-8") for p in parts)
    return int.from_bytes(
        hashlib.blake2b(payload, digest_size=8).digest(), "big")


def _stable_bucket(parts: tuple, space: int) -> int:
    return _bit(*parts) % space


@dataclasses.dataclass(frozen=True)
class Coverage:
    """The coverage a single history reached: the bit set plus
    per-family counts (for reporting — the bits alone are what the
    corpus accumulates)."""
    bits: frozenset
    overlap_bits: int
    kgram_bits: int
    adjacency_bits: int

    def __len__(self):
        return len(self.bits)


def _overlap_class(at_invoke: bool, at_complete: bool) -> str:
    if at_invoke and at_complete:
        return "throughout"
    if at_invoke:
        return "ended-during"
    if at_complete:
        return "began-during"
    return "within"


def extract_coverage(history: Iterable[dict]) -> Coverage:
    """One pass over a simulated history (journal order: invokes and
    completions interleaved, nemesis info ops included) -> Coverage.

    Fault activity is derived from the history itself — the nemesis
    ops' f names (START_F/STOP_F) — so coverage needs no side channel
    from the scenario that produced the history."""
    bits: set = set()
    n_overlap = n_kgram = n_adj = 0

    active: set = set()            # fault kinds active right now
    # process -> (active-at-invoke snapshot, kinds seen active while
    # in flight, f)
    open_ops: dict = {}
    # per-process (f, type) orderings for the k-gram digests
    per_process: dict = {}
    last_client_f: str | None = None
    # nemesis events waiting for their first following client op
    pending_after: list = []
    # (kind, opf) -> overlapped-op count, for the cumulative buckets
    ov_counts: dict = {}

    for op in history:
        proc = op.get("process")
        f = op.get("f")
        typ = op.get("type")
        if proc == "nemesis":
            kind = START_F.get(f)
            if kind is not None:
                if kind not in active:
                    active.add(kind)
                    for st in open_ops.values():
                        st[1].add(kind)
            elif f in STOP_F:
                active.discard(STOP_F[f])
            # adjacency: client op just before, and (deferred) the
            # first client op after this nemesis event
            if typ == "invoke" or typ == "info":
                if last_client_f is not None:
                    b = _bit("adj", f, last_client_f, "before")
                    if b not in bits:
                        bits.add(b)
                        n_adj += 1
                pending_after.append(f)
            continue
        if not isinstance(proc, int):
            continue
        # client op
        if f is not None:
            last_client_f = f
            for nf in pending_after:
                b = _bit("adj", nf, f, "after")
                if b not in bits:
                    bits.add(b)
                    n_adj += 1
            pending_after = []
        seq = per_process.setdefault(proc, [])
        seq.append((f, typ))
        if len(seq) >= KGRAM_K:
            gram = tuple(seq[-KGRAM_K:])
            b = _bit("kg", _stable_bucket(("kg",) + gram, KGRAM_SPACE))
            if b not in bits:
                bits.add(b)
                n_kgram += 1
        if typ == "invoke":
            open_ops[proc] = (frozenset(active), set(active), f)
        elif typ in ("ok", "fail", "info"):
            st = open_ops.pop(proc, None)
            if st is None:
                continue
            at_invoke, seen, inv_f = st
            opf = inv_f if inv_f is not None else f
            for kind in seen:
                klass = _overlap_class(kind in at_invoke,
                                       kind in active)
                b = _bit("ov", kind, opf, klass)
                if b not in bits:
                    bits.add(b)
                    n_overlap += 1
                ov_counts[(kind, opf)] = \
                    ov_counts.get((kind, opf), 0) + 1
            if len(seen) >= 2:
                kinds = sorted(seen)
                for i, k1 in enumerate(kinds):
                    for k2 in kinds[i + 1:]:
                        b = _bit("ov2", k1, k2, opf)
                        if b not in bits:
                            bits.add(b)
                            n_overlap += 1
    # cumulative count buckets: n overlapped ops of (kind, f) sets
    # every bucket up to floor(log2 n) — a deeper overlap of the same
    # phase strictly adds bits
    for (kind, opf), n in ov_counts.items():
        for bucket in range(n.bit_length()):
            b = _bit("ovn", kind, opf, bucket)
            if b not in bits:
                bits.add(b)
                n_overlap += 1
    return Coverage(bits=frozenset(bits), overlap_bits=n_overlap,
                    kgram_bits=n_kgram, adjacency_bits=n_adj)


def _site_class(site) -> str:
    """'stream-chunk/w0' -> 'stream-chunk': coverage is over the site
    *kind*, not the per-stream instance name."""
    return str(site).split("/", 1)[0]


def _site_stream(site) -> str | None:
    s = str(site)
    return s.split("/", 1)[1] if "/" in s else None


def extract_chaos_coverage(probes: Iterable[dict],
                           actions: Iterable[str] = ()) -> Coverage:
    """Chaos-run coverage: one pass over the pipeline's probe stream
    (``_platform.probe``) plus the genome's scripted lifecycle actions
    -> Coverage, reusing the search corpus machinery. Families:

      cx    (fault kind x fault-site class x stream-lifecycle-state)
            transitions — WHERE in the stream's life each fault
            landed, the tentpole's recovery-path gradient
      cx2   fault-during-replay conjunction: a fault/inject probe
            inside an open replay-begin..replay-end window on the
            same site — the path single-fault tests never reach
      cxn   recovery-depth log2 buckets per site class (retry k sets
            every bucket up to floor(log2 k): deeper ladders strictly
            add bits)
      ck    k-gram digests of the probe event sequence (bounded
            buckets, same scheme as the history k-grams)
      ca    scripted-action structure: each lifecycle action and each
            adjacent action pair in schedule order

    Probes are emitted synchronously from the worker thread that runs
    the stream, so their order — and therefore the bit set — is
    deterministic for a fixed genome."""
    bits: set = set()
    n_transition = n_kgram = n_action = 0

    states: dict = {}        # stream name -> last lifecycle state
    replay_open: dict = {}   # site class -> replay window open?
    retries: dict = {}       # site class -> deepest retry seen
    seq: list = []           # (event, detail) ordering for k-grams

    def _add(b, fam):
        nonlocal n_transition, n_kgram, n_action
        if b not in bits:
            bits.add(b)
            if fam == "k":
                n_kgram += 1
            elif fam == "a":
                n_action += 1
            else:
                n_transition += 1

    for p in probes:
        ev = p.get("event")
        site = p.get("site", "")
        sc = _site_class(site)
        if ev == "lifecycle":
            states[p.get("stream")] = p.get("state")
            seq.append((ev, p.get("state")))
        elif ev == "replay-begin":
            replay_open[sc] = True
            seq.append((ev, sc))
        elif ev == "replay-end":
            replay_open[sc] = False
            seq.append((ev, sc))
        elif ev in ("fault", "inject", "corrupt"):
            kind = p.get("kind") or ("bitflip" if ev == "corrupt"
                                     else None)
            state = states.get(_site_stream(site), "admitted")
            _add(_bit("cx", kind, sc, state), "t")
            if replay_open.get(sc):
                _add(_bit("cx2", kind, sc), "t")
            if ev == "fault":
                try:
                    r = int(p.get("retry") or 0)
                except (TypeError, ValueError):
                    r = 0
                retries[sc] = max(retries.get(sc, 0), r)
            seq.append((ev, kind))
        else:
            seq.append((ev, sc))
        if len(seq) >= KGRAM_K:
            gram = tuple(seq[-KGRAM_K:])
            _add(_bit("ck", _stable_bucket(("ck",) + gram,
                                           KGRAM_SPACE)), "k")
    for sc, deepest in retries.items():
        for bucket in range(int(deepest).bit_length()):
            _add(_bit("cxn", sc, bucket), "t")
    prev = None
    for a in actions:
        _add(_bit("ca", a), "a")
        if prev is not None:
            _add(_bit("ca", prev, a), "a")
        prev = a
    return Coverage(bits=frozenset(bits), overlap_bits=n_transition,
                    kgram_bits=n_kgram, adjacency_bits=n_action)


class CoverageMap:
    """Corpus-wide accumulated coverage. add() returns the NOVEL bits
    (set difference against everything accumulated so far); encode()
    is a stable binary form (sorted u64, big-endian) so two maps — or
    the same map across runs/platforms — compare byte-for-byte."""

    def __init__(self, bits: Iterable[int] = ()):
        self._bits: set = set(bits)

    def __len__(self) -> int:
        return len(self._bits)

    def __contains__(self, bit: int) -> bool:
        return bit in self._bits

    @property
    def bits(self) -> frozenset:
        return frozenset(self._bits)

    def novel(self, cov: Coverage | Iterable[int]) -> frozenset:
        bits = cov.bits if isinstance(cov, Coverage) else frozenset(cov)
        return bits - self._bits

    def add(self, cov: Coverage | Iterable[int]) -> frozenset:
        new = self.novel(cov)
        self._bits |= new
        return new

    def encode(self) -> bytes:
        return b"".join(struct.pack(">Q", b)
                        for b in sorted(self._bits))

    @classmethod
    def decode(cls, blob: bytes) -> "CoverageMap":
        if len(blob) % 8:
            raise ValueError(f"coverage encoding length {len(blob)} "
                             "is not a multiple of 8")
        return cls(struct.unpack(">Q", blob[i:i + 8])[0]
                   for i in range(0, len(blob), 8))

    def digest(self) -> str:
        """Hex digest of the stable encoding — the one-line identity
        of a whole corpus's coverage (artifacts, logs, tests)."""
        return hashlib.blake2b(self.encode(),
                               digest_size=16).hexdigest()
