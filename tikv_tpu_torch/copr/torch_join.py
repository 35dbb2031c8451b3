"""The device equi-join rung — the port of ``tikv_tpu/copr/jax_join.py``.

It serves a ``[TableScan, Join, *downstream]`` inner join of two warm region
images (two :class:`~tikv_tpu_torch.copr.cache.ColumnBlockCache`), without
decoding rows that do not survive the join:

* **rank path**: both key columns are dictionary-coded.  The probe codes are
  remapped into the build image's code space (``np.searchsorted`` over the
  SORTED build dictionary; the identity when both images share one
  dictionary object), and ``join_rank_probe`` (program #14,
  ``copr/fused_join.py``) takes searchsorted left and right over the
  stable-sorted build codes.  No string materializes.
* **hash path**: int-family key lanes, or the dictionary codes.  The build
  side's unique keys pack into a power-of-two open-addressing table on the
  host (:func:`_build_hash_table`), and ``join_hash_probe`` (program #15)
  walks it per probe row.

Both kernels give each probe row a ``(start, count)`` span into one
stable-sorted build order (ascending key, build-row order within equal keys:
the CPU ``BatchJoinExecutor``'s match order), so pair expansion and the
payload gather are one host path (:func:`join_pairs`, :func:`serve`): the
surviving rows late-materialize through ``Column.take`` /
``EncodedColumn.take`` only.  Zone maps prune the blocks whose key ranges
cannot meet the other side before any key lane decodes.  The descriptors
above the join (Selection, Projection, TopN, Limit) finish on the host
executors (``copr/dag.py:_attach``).

Every plan or data shape the kernels do not cover raises :class:`JoinDecline`
with a named cause, as the reference does; an aggregation above the join
declines ``join_downstream_aggregation`` (the CPU aggregation executors are
not ported), a TypeChunk response ``chunk_encoding_not_ported``.  ``prefer``
forces the rank or hash path where it is feasible, in place of the
reference's global path override.  Not ported: the power-of-two padding of
the kernels' inputs (``_pow2_pad``, a jit compile-key bucket that spans no
rows), the blocking-call sanitizer and the observatory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import encoding, zone_maps
from .dag import ENC_TYPE_DATUM, DagRequest, Join, SelectResponse, TableScan, _attach, \
    make_response_encoder
from .datatypes import Chunk, Column, EvalType
from .executors import BATCH_GROW_FACTOR, BATCH_INITIAL_SIZE, BATCH_MAX_SIZE, ChunkFeedExecutor
from .fused_agg import Unsupported
from .fused_join import EMPTY, MULT, hash_probe, rank_probe

# int-family eval types whose decoded lanes are exact int64 join keys; REAL
# and DECIMAL stay with the CPU oracle
_INT_KEYS = frozenset({EvalType.INT, EvalType.DATETIME, EvalType.DURATION})

_MISS = np.int64(-1)  # the rank path's "no such code" / NULL key; the hash path's is EMPTY

#: the steps of a join, in order, timed into ``stats["seconds"]``: host
#: seconds, but ``kernel`` is the probe launch alone on the card (CUDA events
#: recorded right around it) and ``probe_call`` the host seconds of the
#: wrapper call (checks, output allocation, launch); on the CPU both are the
#: plain version's host seconds
STEPS = ("key_lanes", "remap", "zone_prune", "sort", "table_build", "upload", "probe_call",
         "kernel", "pull", "expansion", "gather", "downstream_encode")


class JoinDecline(Unsupported):
    """A named reason the join rung cannot serve this request (``cause``)."""

    def __init__(self, cause: str):
        super().__init__(cause, cause)


# ---------------------------------------------------------------------------
# plan eligibility
# ---------------------------------------------------------------------------

def analyze_plan(dag: DagRequest):
    """(probe_scan, join, downstream) of a joinable plan: exactly
    ``[TableScan, Join, *downstream]``, an inner join with a bare build-side
    scan; anything else raises a named :class:`JoinDecline`."""
    execs = dag.executors
    joins = [i for i, e in enumerate(execs) if isinstance(e, Join)]
    if len(joins) != 1:
        raise JoinDecline("multi_join" if joins else "not_join_plan")
    if not isinstance(execs[0], TableScan):
        raise JoinDecline("leaf_not_table_scan")
    if joins[0] != 1:
        # a Selection (or worse) below the join: the probe lanes served off
        # the image would disagree with the filtered probe stream
        raise JoinDecline("probe_selection")
    join = execs[1]
    if join.join_type != "inner":
        raise JoinDecline("outer_join")
    if len(join.build) != 1:
        raise JoinDecline("build_selection")
    return execs[0], join, list(execs[2:])


# ---------------------------------------------------------------------------
# key lanes
# ---------------------------------------------------------------------------

class _Side:
    """One side's key-lane view over a warm image's blocks."""

    __slots__ = ("blocks", "kind", "dictionary", "keep", "n_rows")

    def __init__(self, cache, key_idx: int, label: str):
        self.blocks = list(cache.blocks)
        if not self.blocks:
            raise JoinDecline(f"{label}_empty_image")
        self.n_rows = sum(b.n_valid for b in self.blocks)
        kcols = []
        for blk in self.blocks:
            if key_idx >= len(blk.cols):
                raise JoinDecline("key_offset")
            kcols.append(blk.cols[key_idx])
        first = kcols[0]
        if first.dictionary is not None:
            if first.eval_type != EvalType.BYTES:
                raise JoinDecline("key_type")  # ENUM/SET code semantics
            if any(c.dictionary is not first.dictionary for c in kcols):
                raise JoinDecline("unstable_dictionary")
            self.kind, self.dictionary = "dict", first.dictionary
        elif first.eval_type in _INT_KEYS:
            if any(c.dictionary is not None for c in kcols):
                raise JoinDecline("unstable_dictionary")
            self.kind, self.dictionary = "int", None
        else:
            raise JoinDecline("key_type")
        self.keep = np.ones(len(self.blocks), dtype=bool)

    def key_lane(self, blk, key_idx: int):
        """(int64 values or codes, valid mask) of one block's key column,
        decoded WITHOUT caching the decode on the column."""
        col = blk.cols[key_idx]
        nv = blk.n_valid
        data = np.asarray(encoding.decoded_data(col))[:nv]
        if data.dtype == object:
            raise JoinDecline("key_type")
        nulls = np.asarray(encoding.decoded_nulls(col))[:nv]
        return data.astype(np.int64, copy=True), ~nulls


def _remap_for(probe: _Side, build: _Side) -> np.ndarray | None:
    """Probe-code -> build-code remap array (None: a shared dictionary, the
    identity).  Needs a SORTED build dictionary; codes of probe values the
    build side lacks map to ``_MISS``."""
    if probe.dictionary is build.dictionary:
        return None
    if not encoding._dict_map_for(build.dictionary)[1]:
        raise JoinDecline("dict_unsorted")
    bd = np.asarray(build.dictionary, dtype=object)
    pd = np.asarray(probe.dictionary, dtype=object)
    if len(bd) == 0:
        return np.full(len(pd), _MISS, dtype=np.int64)
    pos = np.searchsorted(bd, pd)
    posc = np.minimum(pos, len(bd) - 1)
    hit = np.array([bd[p] == v for p, v in zip(posc, pd)], dtype=bool)
    return np.where(hit, posc, _MISS).astype(np.int64)


# ---------------------------------------------------------------------------
# zone-map block pruning (before any key lane decodes)
# ---------------------------------------------------------------------------

def _zone_intervals(side: _Side, key_idx: int):
    """Per-block key interval from the block zones: ``(lo, hi)``, ``None``
    (unknown: keep, and poison the side's global bound), or ``"empty"`` (no
    live key: prunable outright for an inner join)."""
    out = []
    for blk in side.blocks:
        z = (blk.zones or {}).get(key_idx)
        if z is None:
            out.append(None)
        elif z.lo is None:
            out.append("empty")
        else:
            out.append((z.lo, z.hi))
    return out


def _map_interval(iv, remap: np.ndarray | None, probe_sorted: bool):
    """A probe-side code interval carried into build code space.  The remap
    is monotone only over a sorted probe dictionary; otherwise the interval
    is unknown and pruning stands down for it."""
    if iv is None or iv == "empty" or remap is None:
        return iv
    if not probe_sorted:
        return None
    lo, hi = int(iv[0]), int(iv[1])
    live = remap[lo:hi + 1]
    live = live[live >= 0]
    if live.size == 0:
        return "empty"
    return (int(live.min()), int(live.max()))


def _global_bound(ivs):
    """(lo, hi) over the blocks, or None when any interval is unknown."""
    lo = hi = None
    for iv in ivs:
        if iv == "empty":
            continue
        if iv is None:
            return None
        lo = iv[0] if lo is None else min(lo, iv[0])
        hi = iv[1] if hi is None else max(hi, iv[1])
    return None if lo is None else (lo, hi)


def _prune_side(side: _Side, ivs, other_bound) -> None:
    for i, iv in enumerate(ivs):
        if iv == "empty":
            side.keep[i] = False
        elif (iv is not None and other_bound is not None
                and (iv[1] < other_bound[0] or iv[0] > other_bound[1])):
            side.keep[i] = False


def _zone_prune(probe: _Side, build: _Side, join: Join, remap: np.ndarray | None,
                probe_cache, build_cache) -> tuple[int, int]:
    """Drop the blocks whose key ranges cannot meet the other side.
    Returns (examined, pruned), also counted in ``zone_maps.PRUNE_COUNTS``."""
    if not zone_maps.enabled():
        return (0, 0)
    if not (zone_maps.ensure_zones(probe_cache) and zone_maps.ensure_zones(build_cache)):
        return (0, 0)
    p_ivs = _zone_intervals(probe, join.left_key)
    b_ivs = _zone_intervals(build, join.right_key)
    if remap is not None:
        p_sorted = encoding._dict_map_for(probe.dictionary)[1]
        p_ivs = [_map_interval(iv, remap, p_sorted) for iv in p_ivs]
    _prune_side(probe, p_ivs, _global_bound(b_ivs))
    _prune_side(build, b_ivs, _global_bound(p_ivs))
    examined = len(probe.blocks) + len(build.blocks)
    pruned = int((~probe.keep).sum()) + int((~build.keep).sum())
    zone_maps.count_prune("join", "examined", examined)
    zone_maps.count_prune("join", "pruned", pruned)
    return (examined, pruned)


# ---------------------------------------------------------------------------
# the hash table (host), pair expansion and late materialization
# ---------------------------------------------------------------------------

def _build_hash_table(ukeys, ustarts, ucounts):
    """Pack the unique build keys into the open-addressing table on the
    host, as the reference does: its slots are the kernel's slots.  Each
    round claims every first contender of a free slot, the losers step to
    their next slot; slots only flip empty -> occupied, so every slot a key
    stepped past stays occupied and the probe-until-empty walk is sound."""
    if np.any(ukeys == EMPTY):
        raise JoinDecline("sentinel_key")
    size = 8
    while size < 2 * len(ukeys):
        size <<= 1
    shift = np.uint64(64 - (size.bit_length() - 1))
    tk = np.full(size, EMPTY, dtype=np.int64)
    ts = np.zeros(size, dtype=np.int64)
    tc = np.zeros(size, dtype=np.int64)
    slots = ((ukeys.astype(np.uint64) * np.uint64(MULT)) >> shift).astype(np.int64)
    pending = np.arange(len(ukeys))
    while pending.size:
        s = slots[pending]
        order = np.argsort(s, kind="stable")
        so = s[order]
        lead = np.ones(so.size, dtype=bool)
        lead[1:] = so[1:] != so[:-1]
        cand = order[lead]
        win = cand[tk[s[cand]] == EMPTY]
        idx = pending[win]
        tk[s[win]] = ukeys[idx]
        ts[s[win]] = ustarts[idx]
        tc[s[win]] = ucounts[idx]
        placed = np.zeros(pending.size, dtype=bool)
        placed[win] = True
        pending = pending[~placed]
        slots[pending] = (slots[pending] + 1) & (size - 1)
    return tk, ts, tc


def _gather_build(build: _Side, bschema, bids: np.ndarray) -> list[Column]:
    """The build side's output columns for the surviving pairs: a per-block
    ``take`` decodes ONLY the selected rows; dictionary payloads stay codes
    when every block shares one dictionary object, else the survivors
    decode."""
    k = len(bids)
    sels = []
    gbase = 0
    for blk in build.blocks:
        m = (bids >= gbase) & (bids < gbase + blk.n_valid)
        pos = np.flatnonzero(m)
        if pos.size:
            sels.append((blk, pos, bids[pos] - gbase))
        gbase += blk.n_valid
    out = []
    for j, (et, frac) in enumerate(bschema):
        d0 = build.blocks[0].cols[j].dictionary
        shared = d0 is not None and all(b.cols[j].dictionary is d0 for b in build.blocks)
        vals = None
        nulls = np.zeros(k, dtype=bool)
        for blk, pos, local in sels:
            piece = blk.cols[j].take(local)
            if piece.dictionary is not None and not shared:
                piece = piece.decoded()
                if piece.dictionary is not None:
                    raise JoinDecline("payload_dict")
            pdata = np.asarray(piece.data)
            if vals is None:
                vals = np.zeros(k, dtype=pdata.dtype)
            vals[pos] = pdata
            nulls[pos] = np.asarray(piece.nulls)
        if vals is None:
            vals = np.zeros(k, dtype=object if et == EvalType.BYTES else np.int64)
        out.append(Column(et, vals, nulls, frac, dictionary=d0 if shared else None))
    return out


def _expand_pairs(starts, counts, sorted_ids):
    """(probe concat index, build global row id) per surviving pair, in the
    CPU oracle's order: probe stream order, build-row order within one probe
    row's matches."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return None, None
    pidx = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    offs = (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))
    bpos = np.repeat(starts.astype(np.int64), counts) + offs
    return pidx, sorted_ids[bpos]


# ---------------------------------------------------------------------------
# join_pairs and serve
# ---------------------------------------------------------------------------

@dataclass
class JoinPairs:
    """The surviving row pairs of a join, before any payload is gathered.

    ``pidx`` indexes the concatenated kept probe blocks (``parts``: block,
    concat base, valid rows, global base), ``bids`` the build image's global
    rows (pruned blocks included); both None when no pair survives.
    ``inputs`` is a check hook: the host arrays the probe kernel took (the
    sorted build keys, or the table's three arrays, then the probe keys),
    None when it did not launch, so that a kernel can be held to its plain
    version on exactly the main path's inputs."""

    path: str
    build: _Side
    parts: list
    pidx: np.ndarray | None
    bids: np.ndarray | None
    stats: dict = field(default_factory=dict)
    inputs: tuple | None = None

    def probe_rows(self) -> np.ndarray:
        """The probe image's global row of each pair."""
        if self.pidx is None:
            return np.empty(0, dtype=np.int64)
        shift = np.zeros(len(self.parts), dtype=np.int64)
        bases = np.zeros(len(self.parts), dtype=np.int64)
        for i, (_blk, cbase, _nv, gbase) in enumerate(self.parts):
            bases[i], shift[i] = cbase, gbase - cbase
        return self.pidx + shift[np.searchsorted(bases, self.pidx, side="right") - 1]

    def build_rows(self) -> np.ndarray:
        """The build image's global row of each pair."""
        return np.empty(0, dtype=np.int64) if self.bids is None else self.bids


def join_pairs(dag: DagRequest, probe_cache, build_cache, prefer: str | None = None,
               device="cuda") -> JoinPairs:
    """The pairs of a joinable plan over two warm images: key lanes, remap,
    zone pruning, the stable sort of the build keys, the probe kernel on
    ``device`` (the plain versions on the CPU) and the pair expansion.
    ``stats`` carries the row counts, the zone-prune pair and each step's
    seconds (``STEPS``)."""
    _probe_scan, join, _downstream = analyze_plan(dag)
    return _join_pairs(join, probe_cache, build_cache, prefer, torch.device(device))


def _join_pairs(join: Join, probe_cache, build_cache, prefer, device) -> JoinPairs:
    secs = dict.fromkeys(STEPS, 0.0)
    probe = _Side(probe_cache, join.left_key, "probe")
    build = _Side(build_cache, join.right_key, "build")
    if probe.kind != build.kind:
        raise JoinDecline("key_form_mismatch")
    if probe.kind == "int":
        p_et = probe.blocks[0].cols[join.left_key].eval_type
        b_et = build.blocks[0].cols[join.right_key].eval_type
        if p_et != b_et:
            raise JoinDecline("key_form_mismatch")

    t = time.perf_counter()
    remap = _remap_for(probe, build) if probe.kind == "dict" else None
    secs["remap"] += time.perf_counter() - t
    feasible = ("rank", "hash") if probe.kind == "dict" else ("hash",)
    path = prefer if prefer in feasible else feasible[0]

    t = time.perf_counter()
    examined, pruned = _zone_prune(probe, build, join, remap, probe_cache, build_cache)
    secs["zone_prune"] = time.perf_counter() - t

    # build lanes: the kept blocks concatenated, global row ids, stable sort
    t = time.perf_counter()
    bkeys, bids = [], []
    gbase = 0
    for i, blk in enumerate(build.blocks):
        if build.keep[i]:
            k, valid = build.key_lane(blk, join.right_key)
            bkeys.append(k[valid])
            bids.append(gbase + np.flatnonzero(valid))
        gbase += blk.n_valid
    bkeys = np.concatenate(bkeys) if bkeys else np.empty(0, dtype=np.int64)
    bids = np.concatenate(bids) if bids else np.empty(0, dtype=np.int64)
    secs["key_lanes"] += time.perf_counter() - t
    t = time.perf_counter()
    perm = np.argsort(bkeys, kind="stable")
    sorted_keys = bkeys[perm]
    sorted_ids = bids[perm]
    secs["sort"] = time.perf_counter() - t

    # probe lanes: the kept blocks in stream order, NULLs to the miss key,
    # dictionary codes remapped into build code space
    miss = _MISS if path == "rank" else np.int64(EMPTY)
    parts = []
    pkeys = []
    cb = gb = 0
    for i, blk in enumerate(probe.blocks):
        if probe.keep[i]:
            t = time.perf_counter()
            k, valid = probe.key_lane(blk, join.left_key)
            t2 = time.perf_counter()
            if remap is not None:
                if len(remap) == 0:
                    valid = np.zeros(len(k), dtype=bool)
                else:
                    k = np.where(valid, remap[np.clip(k, 0, len(remap) - 1)], k)
                    valid = valid & (k != _MISS)
            k[~valid] = miss
            secs["key_lanes"] += t2 - t
            secs["remap"] += time.perf_counter() - t2
            parts.append((blk, cb, blk.n_valid, gb))
            pkeys.append(k)
            cb += blk.n_valid
        gb += blk.n_valid
    n_probe = cb
    pkeys = np.concatenate(pkeys) if pkeys else np.empty(0, dtype=np.int64)

    stats = {"build_rows": build.n_rows, "probe_rows": probe.n_rows, "out_rows": 0,
             "prune": (examined, pruned), "seconds": secs}
    pidx = out_bids = host = None
    if n_probe and len(sorted_keys):
        if path == "hash":
            t = time.perf_counter()
            lead = np.ones(len(sorted_keys), dtype=bool)
            lead[1:] = sorted_keys[1:] != sorted_keys[:-1]
            ustarts = np.flatnonzero(lead).astype(np.int64)
            ucounts = np.diff(np.append(ustarts, len(sorted_keys)))
            table = _build_hash_table(sorted_keys[ustarts], ustarts, ucounts)
            secs["table_build"] = time.perf_counter() - t
            host = (*table, pkeys)
        else:
            host = (sorted_keys, pkeys)
        t = time.perf_counter()
        dev = [torch.from_numpy(a).to(device) for a in host]
        secs["upload"] = time.perf_counter() - t
        probe_fn = rank_probe if path == "rank" else hash_probe
        timing = [] if device.type == "cuda" else None
        t = time.perf_counter()
        starts, counts = probe_fn(*dev, timing=timing)
        secs["probe_call"] = secs["kernel"] = time.perf_counter() - t
        t = time.perf_counter()
        starts, counts = starts.cpu().numpy(), counts.cpu().numpy()
        secs["pull"] = time.perf_counter() - t
        if timing:
            secs["kernel"] = timing[0][0].elapsed_time(timing[0][1]) / 1e3
        t = time.perf_counter()
        pidx, out_bids = _expand_pairs(starts, counts, sorted_ids)
        secs["expansion"] = time.perf_counter() - t
        if pidx is not None:
            stats["out_rows"] = len(pidx)
    return JoinPairs(path, build, parts, pidx, out_bids, stats, host)


def serve(dag: DagRequest, probe_cache, build_cache, prefer: str | None = None,
          device="cuda"):
    """Run a warm two-image join plan: ``(SelectResponse, path, stats)``, as
    ``jax_join.serve`` returns, with ``stats`` from :func:`join_pairs`.
    Raises :class:`JoinDecline` on any shape the rung does not cover.  The
    response bytes equal the CPU pipeline's: the match order is the CPU
    join's, and the descriptors above the join run the host executors."""
    probe_scan, join, downstream = analyze_plan(dag)
    if dag.encode_type != ENC_TYPE_DATUM:
        raise JoinDecline("chunk_encoding_not_ported")
    pschema = [(c.ftype.eval_type, c.ftype.decimal) for c in probe_scan.columns_info]
    bschema = [(c.ftype.eval_type, c.ftype.decimal) for c in join.build[0].columns_info]
    # the chain is built before any lane decodes, so that a plan it cannot
    # finish declines first; the feed reads the chunks as they are pulled
    chunks: list[Chunk] = []
    ex = ChunkFeedExecutor(pschema + bschema, chunks)
    try:
        for desc in downstream:
            ex = _attach(ex, desc)
    except Unsupported as exc:
        raise JoinDecline(exc.cause) from exc

    pairs = _join_pairs(join, probe_cache, build_cache, prefer, torch.device(device))
    stats = pairs.stats
    secs = stats["seconds"]
    t = time.perf_counter()
    pidx, out_bids = pairs.pidx, pairs.bids
    if pidx is not None:
        for blk, base, nv, _gbase in pairs.parts:
            lo = np.searchsorted(pidx, base, side="left")
            hi = np.searchsorted(pidx, base + nv, side="left")
            if lo == hi:
                continue
            local = pidx[lo:hi] - base
            cols = [c.take(local) for c in blk.cols]
            cols += _gather_build(pairs.build, bschema, out_bids[lo:hi])
            chunks.append(Chunk.full(cols))
    secs["gather"] = time.perf_counter() - t

    t = time.perf_counter()
    enc = make_response_encoder(dag)
    batch = BATCH_INITIAL_SIZE
    while True:
        r = ex.next_batch(batch)
        if r.chunk.num_rows:
            enc.add_chunk(r.chunk, dag.output_offsets)
        if r.is_drained:
            break
        if batch < BATCH_MAX_SIZE:
            batch = min(batch * BATCH_GROW_FACTOR, BATCH_MAX_SIZE)
    resp: SelectResponse = enc.to_response()
    secs["downstream_encode"] = time.perf_counter() - t
    return resp, pairs.path, stats
