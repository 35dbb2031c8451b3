"""Mesh-sharded coprocessor evaluation — the port of ``tikv_tpu/parallel/mesh.py``.

The JAX package shards a super-block's rows over the ``regions`` axis of a
``jax.sharding.Mesh`` and the group state over its ``groups`` axis, and one
``shard_map`` program per step computes each shard's partial states and
reduces them with collectives.  Here the mesh is single-controller too: a
:class:`TorchMesh` is a ``(regions, groups)`` grid of ``torch.device``, and
one Python process drives every shard.

* Per shard, the port's existing kernels compute the shard's state on the
  shard's device: the grouped pair (``copr/fused_group_agg.py``) for
  ``mesh.agg_step`` (program #16), the top-K kernels (``copr/fused_topn.py``)
  for ``mesh.topn_step`` (#18), the batch kernels (``copr/fused_batch.py``)
  for each device's slabs in ``mesh.xshard`` (#20), and for
  ``mesh.grouped_step`` (#17) the grouped pair with ids from the group
  dictionary the shards build on the devices (``copr/fused_dict.py``).
* The collectives (``_collective``, ``_combine``) are one step: the shards'
  packed states are copied to the merging device (``.to(dev,
  non_blocking=True)``, a no-op where they share it), where ``mesh_merge``
  (``copr/fused_mesh.py``) folds them in shard order, with no float atomics,
  so reruns are bit-identical.  ``mesh.topn_fin`` (#19) merges the shards'
  runs with ``topn_merge`` and packs them with ``topn_pack``.
* A mesh's device list may repeat a device: ``make_mesh(["cuda:0"] * 8)``
  runs eight shards on one card, as the JAX package's tests run eight
  virtual CPU devices; ``make_mesh(["cpu"] * 8)`` runs the plain versions.
  Shard ``k`` of the ``regions`` axis always holds rows ``block_base + k *
  rows_per_shard ...``, whichever device it sits on.

``first`` has no merge rule (its carry is a paired argmin): the sharded
evaluators refuse plans that use it with ``ValueError``, as the JAX package
does, and the caller keeps the single-device route.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch

from ..copr import encoding, fused_batch, fused_mesh, zone_maps
from ..copr import fused_dict as fd
from ..copr import fused_group_agg as ga
from ..copr import fused_topn as ft
from ..copr.dag_wire import dag_from_wire
from ..copr.datatypes import EvalType
from ..copr.fused_agg import NO_ROW, Image
from ..copr.groupby import GroupDict
from ..copr.torch_eval import (
    TorchDagEvaluator,
    XRegionPending,
    _analyze,
    _batch_schema,
    _check_tasks,
    _nullable,
    _prefetch,
    xregion_specs,
)


class TorchMesh:
    """A ``(regions, groups)`` grid of devices: ``devices`` is an object
    array of ``torch.device``, ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"regions": devices.shape[0], "groups": devices.shape[1]}
        self.size = devices.size

    @property
    def lead(self) -> torch.device:
        """The device at position (0, 0): where merged results are read."""
        return self.devices[0, 0]


def make_mesh(devices=None, groups: int = 1) -> TorchMesh:
    """A (regions × groups) mesh over the given devices, or every CUDA
    device; ``RuntimeError`` when CUDA is asked for and there is none.  The
    list may repeat a device; it must be all CUDA or all CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: no CUDA device is available")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}")
        devs.append(d)
    if not devs or groups < 1 or len(devs) % groups:
        raise ValueError("device count must divide into group shards")
    if len({d.type for d in devs}) != 1:
        raise ValueError("a mesh's devices must be all CUDA or all CPU")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return TorchMesh(arr.reshape(len(devs) // groups, groups))


def _flat_regions_mesh(mesh: TorchMesh) -> TorchMesh:
    """A ``regions``-only view over every device of ``mesh``: the warm
    sharded program has no use for the ``groups`` axis (its state is a
    small (R, capacity) carry), so slabs shard over all devices."""
    return TorchMesh(mesh.devices.reshape(-1, 1))


# the aggregates whose carry has a mesh merge rule; the rule itself is each
# leaf's kind (``fused_group_agg``'s ``_merge``, ``ga_merge`` on the card).
# ``first`` is not here: its carry is a paired (value, row) argmin that a
# leaf-wise merge cannot express
_MERGE = frozenset(("count", "sum", "avg", "var_pop", "min", "max", "bit_and", "bit_or",
                    "bit_xor"))


def mesh_mergeable(agg_rpns) -> bool:
    """True when every aggregate (``(op, rpn)`` pairs) has a mesh merge rule."""
    return all(op in _MERGE for op, _rpn in agg_rpns)


def _require_mesh_mergeable(agg_rpns) -> None:
    for op, _rpn in agg_rpns:
        if op not in _MERGE:
            raise ValueError(f"aggregate {op!r} has no mesh merge rule")


def _n_valid(n_valid: int, total: int) -> int:
    """The super-block's valid rows (a prefix of it, as ``_marshal_block``'s
    ``valid`` lane)."""
    if not 0 <= n_valid <= total:
        raise ValueError(f"{n_valid} valid rows in a super-block of {total}")
    return int(n_valid)


def _shard_images(shard_devices, rows_per_shard: int, data, f64, nulls, n_valid: int,
                  block_base: int, gids=None) -> list[Image]:
    """One super-block's rows as one single-block ``Image`` per shard: shard
    ``k`` holds rows ``[k * rows_per_shard, (k + 1) * rows_per_shard)``,
    ``n_valid`` clipped to them, and ``offsets = block_base + k *
    rows_per_shard``.  ``data`` are host arrays (REAL as f64, else int64
    values) of at most the super-block's rows, ``nulls`` host bool arrays or
    None (NOT NULL); ``gids`` the host group ids.  The rows are staged in one
    pinned host buffer and copied once to each distinct device."""
    total = rows_per_shard * len(shard_devices)
    pin = any(d.type == "cuda" for d in shard_devices)
    null_at = [j for j, m in enumerate(nulls) if m is not None]
    buf = torch.zeros((len(data), total), dtype=torch.int64, pin_memory=pin)
    nbuf = torch.ones((len(null_at), total), dtype=torch.bool, pin_memory=pin)
    bv, nv = buf.numpy(), nbuf.numpy()
    for j, d in enumerate(data):
        d = np.asarray(d)
        bv[j, : len(d)] = d.view(np.int64) if d.dtype == np.float64 else d
    for r, j in enumerate(null_at):
        m = np.asarray(nulls[j], dtype=bool)
        nv[r, : len(m)] = m
    gbuf = None
    if gids is not None:
        gbuf = torch.zeros(total, dtype=torch.int32, pin_memory=pin)
        g = np.asarray(gids)
        gbuf.numpy()[: len(g)] = g
    staged = {}
    for dev in shard_devices:
        if dev not in staged:
            staged[dev] = tuple(None if t is None else t.to(dev, non_blocking=True)
                                for t in (buf, nbuf, gbuf))
    rps = rows_per_shard
    images = []
    for k, dev in enumerate(shard_devices):
        b, nb, gb = staged[dev]
        lo, hi = k * rps, (k + 1) * rps
        cols = [b[j, lo:hi].view(1, rps) for j in range(len(data))]
        cols = [c.view(torch.float64) if is_f else c for c, is_f in zip(cols, f64)]
        nul = [None] * len(data)
        for r, j in enumerate(null_at):
            nul[j] = nb[r, lo:hi].view(1, rps)
        images.append(Image(cols, nul, min(max(n_valid - lo, 0), rps), 1, rps, dev,
                            block_base + lo, None if gb is None else gb[lo:hi].view(1, rps)))
    return images


def _shard_states(prog, images, cap: int, lead):
    """Each shard's packed state at ``cap`` slots from the identity (the
    grouped pair on the shard's device, ids from each image's ``gids``),
    stacked on the lead device: ``(S, n_int, C)`` and ``(S, n_f64, C)``."""
    pi = torch.empty((len(images), prog.n_int, cap), dtype=torch.int64, device=lead)
    pf = torch.empty((len(images), prog.n_f64, cap), dtype=torch.float64, device=lead)
    for k, img in enumerate(images):
        if img.device.type == "cpu":
            st = ga.fused_group_agg(prog, img, cap)
        else:
            st = (pi[k], pf[k]) if img.device == lead else ga.init_packed(prog, cap, img.device)
            scratch = ga.new_partials(prog, img, cap)
            ga.launch_partials(prog, img, cap, scratch)
            ga.launch_combine(prog, img, cap, scratch, None, st)
        if img.device.type == "cpu" or img.device != lead:
            pi[k].copy_(st[0], non_blocking=True)
            pf[k].copy_(st[1], non_blocking=True)
    return pi, pf


# ---------------------------------------------------------------------------
# Program #16: the sharded aggregation step
# ---------------------------------------------------------------------------

class ShardedDagEvaluator:
    """Multi-device aggregation step of an eligible aggregation DAG
    (``mesh.ShardedDagEvaluator``).

    ``step(col_data, col_nulls, n_valid, gids, state, block_base)`` consumes
    one super-block of ``rows_per_shard`` rows per ``regions`` shard; the
    state is one packed slice per ``groups`` member (member ``g`` keeps slots
    ``[g*C/G, (g+1)*C/G)`` on the device at ``(0, g)``) and is updated in
    place.  Every plan runs the grouped program with host group ids, a plan
    without GROUP BY at ``capacity`` slots with ids 0, and the tracker (the
    global index of each slot's first active row) always runs.  ``dag`` is
    a ``DagRequest`` or its wire dict.  ``ValueError`` for a plan without an
    aggregation or with ``first``; the port's limits raise ``Unsupported``
    (``real_group_capacity_not_ported`` for f64 leaves past the kernels'
    shared-memory slots)."""

    def __init__(self, dag, mesh: TorchMesh, rows_per_shard: int, capacity: int = 16):
        self.ev = TorchDagEvaluator(dag, block_rows=rows_per_shard, device=mesh.lead)
        plan = self.ev.plan
        if plan.agg is None:
            raise ValueError("sharded evaluation requires an aggregation DAG")
        _require_mesh_mergeable(plan.agg_rpns)
        self.mesh = mesh
        self.rows_per_shard = rows_per_shard
        self.n_regions = mesh.shape["regions"]
        self.n_groups = mesh.shape["groups"]
        if capacity % self.n_groups:
            raise ValueError(f"capacity {capacity} does not divide into {self.n_groups} groups")
        self.capacity = capacity
        self.total_rows = rows_per_shard * self.n_regions
        self.prog = ga.compile_group_program(plan.sel_rpns, plan.agg_rpns, plan.device_cols,
                                             plan.schema, None, track=True)
        ga.check_capacity(self.prog, capacity)
        self.shard_devices = [mesh.devices[k, 0] for k in range(self.n_regions)]
        self.member_devices = [mesh.devices[0, g] for g in range(self.n_groups)]
        self._col_f64 = [plan.schema[i][0] == EvalType.REAL for i in plan.device_cols]
        self._tables = [fused_mesh.merge_table([range(self.n_regions)], self.n_regions, d)
                        for d in self.member_devices]

    @property
    def slice_width(self) -> int:
        return self.capacity // self.n_groups

    def init_state(self) -> list:
        """The identity state: one ``(ints, flts)`` slice per ``groups`` member."""
        return [ga.init_packed(self.prog, self.slice_width, d) for d in self.member_devices]

    def step(self, col_data, col_nulls, n_valid: int, gids, state, block_base: int = 0) -> list:
        """Fold one super-block into ``state``: ``col_data`` per device
        column (``ev.plan.device_cols``), ``col_nulls`` per nullable one
        (``ev.plan.nullable_cols``), ``n_valid`` the valid rows (a prefix),
        ``gids`` int32 host group ids.  The shards' states are
        folded in shard order, then combined into the carry: carry ⊕ (s0 ⊕
        s1 ⊕ …), as ``_combine(carry, psum(leaf))``."""
        plan = self.ev.plan
        nulls_of = dict(zip(plan.nullable_cols, col_nulls))
        images = _shard_images(self.shard_devices, self.rows_per_shard, list(col_data),
                               self._col_f64, [nulls_of.get(i) for i in plan.device_cols],
                               _n_valid(n_valid, self.total_rows), block_base, gids)
        pi, pf = _shard_states(self.prog, images, self.capacity, self.mesh.lead)
        w = self.slice_width
        for g, dev in enumerate(self.member_devices):
            carry = (state[g][0][None], state[g][1][None])
            fused_mesh.mesh_merge(self.prog, (pi.to(dev, non_blocking=True),
                                              pf.to(dev, non_blocking=True)),
                                  self._tables[g], carry, g * w, (g + 1) * w, out=carry)
        return state

    def run_arrays(self, columns: dict, n_valid: int, gids) -> list:
        """One super-block given per-column ``(data, nulls)`` host arrays."""
        return self.run_blocks([(columns, n_valid, gids)])

    def run_blocks(self, blocks) -> list:
        """Super-blocks ``[(columns, n_valid, gids), ...]`` in stream order,
        the state carried on the devices between them."""
        plan = self.ev.plan
        state = self.init_state()
        for b, (columns, n_valid, gids) in enumerate(blocks):
            state = self.step([columns[i][0] for i in plan.device_cols],
                              [columns[i][1] for i in plan.nullable_cols], n_valid, gids, state,
                              block_base=b * self.total_rows)
        return state

    def packed(self, state):
        """The members' slices concatenated on the lead device: the packed
        ``(n_int, C)`` / ``(n_f64, C)`` state ``_finalize_agg`` reads."""
        lead = self.mesh.lead
        return (torch.cat([s[0].to(lead) for s in state], dim=1),
                torch.cat([s[1].to(lead) for s in state], dim=1))

    def unpack(self, state):
        """The state as host arrays in the JAX package's form: ``(first,
        ((leaf, ...) per aggregate))``."""
        ints, flts = (t.cpu().numpy() for t in self.packed(state))
        leaves = self.prog.leaves
        carries = tuple(tuple((flts if leaves[i].is_f64 else ints)[leaves[i].slot] for i in own)
                        for own in self.prog.agg_leaves)
        return ints[0], carries


class MeshServingRunner:
    """Endpoint-facing mesh execution of an eligible aggregation DAG
    (``mesh.MeshServingRunner``): the scan source's rows are decoded on the
    host into super-blocks (one ahead, on a worker thread), given host group
    ids, and sharded over ``regions``; the group state stays sharded over
    ``groups`` between blocks.  Decode, group ids and finalize are the
    single-device evaluator's, so the response is byte-identical to the
    one-device (and CPU) answer."""

    def __init__(self, dag, mesh: TorchMesh, rows_per_shard: int = 1024):
        if isinstance(dag, dict):
            dag = dag_from_wire(dag)
        # eligibility first, before any evaluator is built: the rejection
        # stays cheap
        if _analyze(dag).agg is None:
            raise ValueError("mesh serving requires an aggregation DAG")
        self.mesh = mesh
        self.rows_per_shard = rows_per_shard
        self.n_groups = mesh.shape["groups"]
        # the smallest multiple of n_groups >= 16
        cap = 16 * self.n_groups // gcd(16, self.n_groups)
        self.sharded = ShardedDagEvaluator(dag, mesh, rows_per_shard, capacity=cap)
        self.total_rows = self.sharded.total_rows
        self.decode_ev = TorchDagEvaluator(dag, block_rows=self.total_rows, device=mesh.lead)

    def _grow(self, state, n_groups: int) -> list:
        """The state migrated to a capacity (doubled) that holds
        ``n_groups``; ``Unsupported`` past the kernels' f64 slots."""
        cap = self.sharded.capacity
        while n_groups > cap:
            cap *= 2
        # as the single-device route (``_capacity_for``): cut back to the
        # kernels' slot limit (a multiple of the groups axis) where it holds
        # the groups
        limit = self.sharded.prog.c_max // self.n_groups * self.n_groups
        if n_groups <= limit < cap:
            cap = limit
        old = self.sharded
        self.sharded = ShardedDagEvaluator(self.decode_ev.dag, self.mesh, self.rows_per_shard,
                                           capacity=cap)
        ints, flts = ga.grow_carry(old.prog, old.packed(state), cap)
        w = self.sharded.slice_width
        return [(ints[:, g * w:(g + 1) * w].contiguous().to(dev),
                 flts[:, g * w:(g + 1) * w].contiguous().to(dev))
                for g, dev in enumerate(self.sharded.member_devices)]

    def run(self, source, cache=None):
        """``TorchDagEvaluator.run``'s signature; the block cache is a
        single-device notion and is ignored here."""
        ev = self.decode_ev
        plan = ev.plan
        total = self.total_rows
        groups = GroupDict()
        state = self.sharded.init_state()
        zero_gids = np.zeros(total, dtype=np.int32)
        block_base = 0
        for cols, n_valid in _prefetch(ev._decode_blocks(source)):
            gids = zero_gids
            if plan.group_rpns:
                gids, n_groups = ev._assign_gids(cols, n_valid, groups)
                if n_groups > self.sharded.capacity:
                    state = self._grow(state, n_groups)
            state = self.sharded.step([cols[i].data for i in plan.device_cols],
                                      [cols[i].nulls for i in plan.nullable_cols], n_valid,
                                      gids, state, block_base=block_base)
            block_base += total
        n_slots = len(groups) if plan.group_rpns else 1
        return ev._finalize_agg(self.sharded.packed(state), self.sharded.prog, n_slots,
                                lambda r: groups.rows[r])


# ---------------------------------------------------------------------------
# Program #17: grouped aggregation with the group dictionary built on device
# ---------------------------------------------------------------------------

class ShardedGroupedEvaluator:
    """Grouped aggregation with the group dictionary built on the devices
    (``mesh.ShardedGroupedEvaluator``, program #17).

    Each ``regions`` shard packs its rows' GROUP BY values into one int64
    key (``dict_keys``), takes the bounded sorted union of the carried
    dictionary and its keys (``dict_union``); the shards' dictionaries,
    gathered on the lead device, are unioned again into the new global
    dictionary, and a row's group id is its key's position in it
    (``dict_ids``, which writes each shard image's ``gids`` on the shard's
    device).  The shards' partial states (the grouped pair) fold through
    ``mesh_merge`` in shard order into the carry, whose slots move to their
    keys' new positions (``perm``).  ``overflow`` replaces dropped groups:
    more than ``capacity`` distinct keys, or a value that does not pack into
    its ``key_bits`` lane; it is sticky, and once set the state is not the
    reference's (it misfiles groups by design).

    The state, ``(dict_keys, (ints, flts), overflow)``, lives on the lead
    device and is replicated in the reference (every member of ``groups``
    computes it): rows shard over the ``regions`` axis only.  ``overflow``
    (int32 ``[1]``, :data:`fused_dict.FLAG_RANGE` | :data:`FLAG_CAPACITY`)
    is updated in place and stays on the device until :meth:`finalize`.
    The group columns ship with the plan's (``ship_cols``, their null masks
    in ``nullable_cols``).  ``ValueError`` without GROUP BY, for an
    aggregate without a merge rule (``first``) or keys that do not pack into
    62 bits; ``Unsupported`` past the kernels' limits."""

    def __init__(self, dag, mesh: TorchMesh, rows_per_shard: int, capacity: int = 64,
                 key_bits: int = 31):
        self.ev = TorchDagEvaluator(dag, block_rows=rows_per_shard, device=mesh.lead)
        plan = self.ev.plan
        if plan.agg is None or not plan.group_rpns:
            raise ValueError("grouped evaluation requires GROUP BY aggregation")
        _require_mesh_mergeable(plan.agg_rpns)
        group_cols = set().union(*(g.referenced_columns() for g in plan.group_rpns))
        self.ship_cols = sorted(set(plan.device_cols) | group_cols)
        self.nullable_cols = _nullable(plan.scan, self.ship_cols)
        # the key kernel reads only the columns its walk references
        key_cols = sorted(group_cols.union(*(r.referenced_columns() for r in plan.sel_rpns)))
        self._key_at = [self.ship_cols.index(c) for c in key_cols]
        self.key_prog = fd.compile_key_program(plan.sel_rpns, plan.group_rpns, key_cols,
                                               plan.schema, key_bits)
        self.prog = ga.compile_group_program(plan.sel_rpns, plan.agg_rpns, self.ship_cols,
                                             plan.schema, None, track=True)
        fd.check_capacity(capacity)
        ga.check_capacity(self.prog, capacity)
        self.mesh = mesh
        self.rows_per_shard = rows_per_shard
        self.n_regions = mesh.shape["regions"]
        self.capacity = capacity
        self.key_bits = key_bits
        self.total_rows = rows_per_shard * self.n_regions
        self.shard_devices = [mesh.devices[k, 0] for k in range(self.n_regions)]
        self._col_f64 = [plan.schema[i][0] == EvalType.REAL for i in self.ship_cols]
        self._table = fused_mesh.merge_table([range(self.n_regions)], self.n_regions, mesh.lead)

    def init_state(self):
        """An empty dictionary, the identity state and no overflow."""
        lead, cap = self.mesh.lead, self.capacity
        return (torch.full((cap,), fd.SENTINEL, dtype=torch.int64, device=lead),
                ga.init_packed(self.prog, cap, lead),
                torch.zeros(1, dtype=torch.int32, device=lead))

    def step(self, col_data, col_nulls, n_valid: int, state, block_base: int = 0):
        """Fold one super-block into ``state`` and return the new state:
        ``col_data`` per shipped column (``ship_cols``), ``col_nulls`` per
        nullable one (``nullable_cols``), ``n_valid`` the valid rows (a
        prefix).  No host synchronisation on the card."""
        dict_keys, (ints, flts), overflow = state
        lead, cap, rps = self.mesh.lead, self.capacity, self.rows_per_shard
        nulls_of = dict(zip(self.nullable_cols, col_nulls))
        images = _shard_images(self.shard_devices, rps, list(col_data), self._col_f64,
                               [nulls_of.get(i) for i in self.ship_cols],
                               _n_valid(n_valid, self.total_rows), block_base)
        # the flag word of each device (the state's own on the lead device)
        # and the carried dictionary on each
        flags, old = {lead: overflow}, {lead: dict_keys}
        for dev in self.shard_devices:
            if dev not in flags:
                flags[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
                old[dev] = dict_keys.to(dev, non_blocking=True)
        keys = [fd.dict_keys(self.key_prog, img.pick(self._key_at), flags[img.device])
                for img in images]
        local = torch.empty((self.n_regions, cap), dtype=torch.int64, device=lead)
        for k, (img, kk) in enumerate(zip(images, keys)):
            if img.device == lead:
                fd.dict_union(old[lead], kk, cap, overflow, out=local[k])
            else:
                local[k].copy_(fd.dict_union(old[img.device], kk, cap, flags[img.device]),
                               non_blocking=True)
        new_dict = fd.dict_union(None, local.view(-1), cap, overflow)
        on = {lead: new_dict}
        perm = torch.empty(cap, dtype=torch.int32, device=lead)
        for k, (img, kk) in enumerate(zip(images, keys)):
            if img.device not in on:
                on[img.device] = new_dict.to(img.device, non_blocking=True)
            img.gids = torch.empty((1, rps), dtype=torch.int32, device=img.device)
            # shard 0 sits on the lead device: its launch also writes the
            # carried slots' new positions
            moved = (dict_keys, perm) if k == 0 else (None, None)
            fd.dict_ids(on[img.device], kk, img.gids.view(-1), *moved)
        parts = _shard_states(self.prog, images, cap, lead)
        out = (torch.empty((1, self.prog.n_int, cap), dtype=torch.int64, device=lead),
               torch.empty((1, self.prog.n_f64, cap), dtype=torch.float64, device=lead))
        fused_mesh.mesh_merge(self.prog, parts, self._table, (ints[None], flts[None]),
                              out=out, perm=perm)
        for dev, flag in flags.items():
            if dev != lead:
                overflow |= flag.to(lead, non_blocking=True)
        return new_dict, (out[0][0], out[1][0]), overflow

    def run_blocks(self, blocks):
        """Super-blocks ``[(columns, n_valid), ...]`` in stream order
        (``columns``: ``{column: (data, nulls)}`` host arrays), the state
        carried on the devices between them."""
        state = self.init_state()
        for b, (columns, n_valid) in enumerate(blocks):
            state = self.step([columns[i][0] for i in self.ship_cols],
                              [columns[i][1] for i in self.nullable_cols], n_valid, state,
                              block_base=b * self.total_rows)
        return state

    def unpack(self, state):
        """The state as host arrays in the JAX package's form: ``(dict_keys,
        first, ((leaf, ...) per aggregate), overflow)``."""
        dict_keys, (ints, flts), overflow = state
        ints, flts = ints.cpu().numpy(), flts.cpu().numpy()
        leaves = self.prog.leaves
        carries = tuple(tuple((flts if leaves[i].is_f64 else ints)[leaves[i].slot] for i in own)
                        for own in self.prog.agg_leaves)
        return dict_keys.cpu().numpy(), ints[0], carries, bool(overflow.item())

    def finalize(self, state) -> dict:
        """The live groups in first-occurrence order (a stable sort of the
        tracker): ``{"keys", "first", "aggs": [per-aggregate leaves],
        "overflow": bool}``, as the JAX package's ``finalize``."""
        dict_keys, first, carries, overflow = self.unpack(state)
        live = dict_keys < fd.SENTINEL
        idx = np.nonzero(live)[0][np.argsort(first[live], kind="stable")]
        return {"keys": dict_keys[idx], "first": first[idx],
                "aggs": [tuple(leaf[idx] for leaf in c) for c in carries],
                "overflow": overflow}


# ---------------------------------------------------------------------------
# Programs #18 and #19: the sharded raw TopN
# ---------------------------------------------------------------------------

class ShardedTopNEvaluator:
    """Raw TopN (TableScan → Selection? → TopN) across the mesh
    (``mesh.ShardedTopNEvaluator``): every ``regions`` shard keeps its own
    running top K (``fused_topn.topn_step``: candidates, then merges into
    the carry), and :meth:`finalize` merges the shards' runs with
    ``topn_merge`` and packs the K winners with ``topn_pack``.  Ties resolve
    in global stream order across shards: each carried entry keeps its
    global row index, which replaces the run's ``src`` word at the merge.
    Payload is every schema column."""

    def __init__(self, dag, mesh: TorchMesh, rows_per_shard: int):
        self.ev = TorchDagEvaluator(dag, block_rows=rows_per_shard, device=mesh.lead)
        plan = self.ev.plan
        if plan.topn is None or plan.agg is not None:
            raise ValueError("sharded TopN requires a raw TopN DAG")
        if plan.topn_program is None:
            raise ValueError("sharded TopN of no rows (K = 0)")
        self.prog = plan.topn_program
        self.k = self.prog.k
        self.mesh = mesh
        self.rows_per_shard = rows_per_shard
        self.n_regions = mesh.shape["regions"]
        self.total_rows = rows_per_shard * self.n_regions
        self.payload_cols = list(range(len(plan.schema)))
        self.nullable_cols = _nullable(plan.scan, self.payload_cols)
        self.shard_devices = [mesh.devices[k, 0] for k in range(self.n_regions)]
        self._pay_f64 = [et == EvalType.REAL for et, _f in plan.schema]

    def init_state(self) -> list:
        """One carry per shard, ``(ints, flts, run, global rows)``; None
        before the shard's first step."""
        return [None] * self.n_regions

    def _winner_rows(self, run: torch.Tensor, prev, base: int) -> torch.Tensor:
        """The global row index of each entry of a merged run: a carried
        entry (``src`` its slot, below K) keeps its row, an image entry's is
        ``base + src - K``; entries of rank 1 get ``NO_ROW``."""
        k = self.k
        src = run[-1]
        from_carry = (src >= 0) & (src < k)
        rows = base + (src - k)
        if prev is not None:
            rows = torch.where(from_carry, prev[src.clamp(0, k - 1)], rows)
        return torch.where(run[0] == 0, rows, NO_ROW)

    def step(self, col_data, col_nulls, n_valid: int, state, block_base: int = 0) -> list:
        """Fold one super-block into every shard's carry: ``col_data`` per
        schema column, ``col_nulls`` per nullable one (``nullable_cols``),
        ``n_valid`` the valid rows (a prefix)."""
        plan = self.ev.plan
        nulls_of = dict(zip(self.nullable_cols, col_nulls))
        images = _shard_images(self.shard_devices, self.rows_per_shard, list(col_data),
                               self._pay_f64, [nulls_of.get(i) for i in self.payload_cols],
                               _n_valid(n_valid, self.total_rows), block_base)
        out = []
        for pay, carry in zip(images, state):
            cand = pay.pick(plan.device_cols)
            ints, flts, nrun, run = ft.topn_step_run(
                self.prog, cand, pay, None if carry is None else carry[:3], src_base=self.k)
            out.append((ints, flts, nrun,
                        self._winner_rows(run, None if carry is None else carry[3],
                                          pay.offsets)))
        return out

    def run_blocks(self, blocks) -> list:
        """Super-blocks ``[(columns, n_valid), ...]`` in stream order."""
        state = self.init_state()
        for b, (columns, n_valid) in enumerate(blocks):
            state = self.step([columns[i][0] for i in self.payload_cols],
                              [columns[i][1] for i in self.nullable_cols], n_valid, state,
                              block_base=b * self.total_rows)
        return state

    def gather(self, state):
        """The inputs of program #19 on the lead device: the shards' runs,
        each entry's global row in place of ``src`` and its position ``s*K +
        slot`` as one more word, ``(S, n_words + 1, K)``; and the shards'
        packed payload as one ``[S, K]`` image."""
        prog, k, lead = self.prog, self.k, self.mesh.lead
        runs, ints_s, flts_s = [], [], []
        for s, (ints, flts, run, rows) in enumerate(state):
            pos = torch.arange(s * k, (s + 1) * k, dtype=torch.int64, device=run.device)
            runs.append(torch.cat([run[:-1], rows[None], pos[None]]).to(lead, non_blocking=True))
            ints_s.append(ints.to(lead, non_blocking=True))
            flts_s.append(flts.to(lead, non_blocking=True))
        cols, nulls = [], []
        for is_f, row, nrow in zip(prog.pay_f64, prog.pay_row, prog.pay_null_row):
            cols.append(torch.stack([(f if is_f else i)[row] for i, f in zip(ints_s, flts_s)]))
            nulls.append(torch.stack([i[nrow] for i in ints_s]).to(torch.bool))
        return torch.stack(runs), Image(cols, nulls, k, len(state), k, lead)

    def merge(self, state):
        """Program #19: :meth:`gather`, the runs merged by ``topn_merge``
        levels down to K, then ``topn_pack`` gathers the winners' payload
        through their positions.  Returns the packed ``(ints, flts)`` and
        the winners' global rows."""
        prog, k, lead = self.prog, self.k, self.mesh.lead
        n_words = prog.n_words
        runs, pay = self.gather(state)
        cuda = lead.type == "cuda"
        final = ft._merge_all(runs, None, cuda=cuda)
        rows = final[n_words - 1]
        run = torch.cat([final[: n_words - 1], final[n_words:]]).contiguous()
        if not cuda:
            return (*ft.pack_plain(prog, run, pay, None, 0)[:2], rows)
        out = (torch.empty((prog.n_int, k), dtype=torch.int64, device=lead),
               torch.empty((prog.n_f64, k), dtype=torch.float64, device=lead))
        ft.launch_pack(prog, run, pay, None, 0, out,
                       torch.empty((n_words, k), dtype=torch.int64, device=lead))
        return out[0], out[1], rows

    def finalize(self, state) -> dict:
        """Every shard's top K merged into the global top K: ``{"rows":
        n_live, "gidx": global row indices, "payload": [(data, nulls) per
        column]}`` as host arrays."""
        prog = self.prog
        if state[0] is None:
            empty = [(np.zeros(0, dtype=np.float64 if f else np.int64), np.zeros(0, dtype=bool))
                     for f in prog.pay_f64]
            return {"rows": 0, "gidx": np.zeros(0, dtype=np.int64), "payload": empty}
        ints, flts, rows = (t.cpu().numpy() for t in self.merge(state))
        live = int((ints[0] == 0).sum())
        payload = [((flts if is_f else ints)[row, :live], ints[nrow, :live].astype(bool))
                   for is_f, row, nrow in zip(prog.pay_f64, prog.pay_row, prog.pay_null_row)]
        return {"rows": live, "gidx": rows[:live], "payload": payload}


# ---------------------------------------------------------------------------
# Program #20: mesh-sharded warm serving of a cross-region batch
# ---------------------------------------------------------------------------

def slab_assignment(caches, mesh: TorchMesh) -> list[dict]:
    """Per cache, ``{device position: block indices}`` over the flat mesh:
    the cache's ``owner_devices`` (a position per block) where it has them,
    else whole regions round-robin, and a lone cache block by block (a
    whole region on one device would leave the others idle)."""
    n = mesh.size
    out = []
    for r, cache in enumerate(caches):
        nb = len(cache.blocks)
        owners = getattr(cache, "owner_devices", None)
        if owners is None or len(owners) != nb or any(not 0 <= o < n for o in owners):
            owners = [b % n for b in range(nb)] if len(caches) == 1 else [r % n] * nb
        assign: dict[int, list[int]] = {}
        for b, pos in enumerate(owners):
            assign.setdefault(pos, []).append(b)
        out.append(assign)
    return out


def device_slab_load(caches, mesh: TorchMesh) -> dict[int, int]:
    """Slabs per device position for a prospective batch, from
    :func:`slab_assignment`."""
    load = dict.fromkeys(range(mesh.size), 0)
    for assign in slab_assignment(caches, mesh):
        for pos, idxs in assign.items():
            load[pos] += len(idxs)
    return load


def _slab_pins(ev, cache, assign: dict, devices, ship, nullable, plan=None) -> dict:
    """Per owner position, the pinned slab stack of one region image:
    ``{position: (data per shipped column [B_d, block_rows], nulls per
    shipped column or None)}``, each on its device.  Pinned on the cache
    under a ``shardslab`` signature (one more of its LRU signatures, a
    second copy of the blocks beside any unary pin), so repeat batches move
    no bytes.  With an encoding ``plan`` (run-length lanes excluded) the
    encoded payloads pin as they are and the kernels widen them; without,
    the decoded lanes pin, and no host decode is left cached."""
    fp = tuple(sorted((pos, tuple(bs)) for pos, bs in assign.items()))
    enc = None if plan is None else (plan.sig, plan.null_sig, cache.enc_version)
    sig = ("shardslab", fp, tuple(str(d) for d in devices), tuple(ship), tuple(nullable),
           ev.block_rows, enc)
    br = ev.block_rows

    def build(_blk):
        out = {}
        for pos, idxs in assign.items():
            dev = devices[pos]
            blocks = [cache.blocks[i] for i in idxs]
            if plan is not None:
                data_np, nulls_np, _refs = encoding.stack_block_payloads(blocks, ship, nullable,
                                                                         plan, br)
            else:
                data_np = []
                for i in ship:
                    host = np.zeros((len(blocks), br), dtype=np.float64
                                    if blocks[0].cols[i].eval_type == EvalType.REAL else np.int64)
                    for bi, b in enumerate(blocks):
                        d = np.asarray(encoding.decoded_data(b.cols[i]))
                        host[bi, : len(d)] = d
                    data_np.append(host)
                nulls_np = []
                for i in nullable:
                    host = np.ones((len(blocks), br), dtype=bool)
                    for bi, b in enumerate(blocks):
                        m = np.asarray(encoding.decoded_nulls(b.cols[i]))
                        host[bi, : len(m)] = m
                    nulls_np.append(host)
            null_of = {i: torch.from_numpy(m).to(dev) for i, m in zip(nullable, nulls_np)}
            out[pos] = ([torch.from_numpy(a).to(dev) for a in data_np],
                        [null_of.get(i) for i in ship])
        return out

    return cache.device_arrays(cache.blocks[0], sig, build)


def xshard_tasks(ev: TorchDagEvaluator, caches, mesh: TorchMesh):
    """The batch kernels' tasks of a sharded cross-region batch: per device
    position that holds slabs, ``(position, tasks)``, a task per region it
    holds (its slabs of that region as one image), in region order; per
    region, its tasks' rows in the stacked parts (device order); and
    ``xregion_specs``' specs, each region's program, each region's (blocks
    examined, pruned) and whether the images ship encoded.  ``ValueError``
    as :func:`launch_xregion_sharded`."""
    _require_mesh_mergeable(ev.plan.agg_rpns)
    specs, group_cols, capacity = xregion_specs(ev, caches)
    devices = list(_flat_regions_mesh(mesh).devices.reshape(-1))
    ship = ev._ship_cols(group_cols)
    nullable = _nullable(ev.plan.scan, ship)
    schema = _batch_schema([ev], ship)
    progs = {dl: ev._batch_program(ship, schema, group_cols, dl) for _d, dl, _n in specs}
    _check_tasks(progs.values(), [capacity] * len(progs))
    plans = encoding.batch_plan(caches, ship, nullable, "mesh_sharded", allow_rle=False)
    assigns = slab_assignment(caches, mesh)
    pins = [_slab_pins(ev, c, a, devices, ship, nullable, None if plans is None else plans[r])
            for r, (c, a) in enumerate(zip(caches, assigns))]
    keeps, prunes, offsets = [], [], []
    for cache in caches:
        stats = zone_maps.PruneStats()
        keeps.append(zone_maps.prune_blocks(cache, ev.plan.sel_rpns, stats))
        prunes.append((stats.examined, stats.pruned))
        nv = np.array([b.n_valid for b in cache.blocks], dtype=np.int64)
        offsets.append(np.concatenate([[0], np.cumsum(nv)[:-1]]).astype(np.int64))
    device_tasks = []
    region_parts: list[list[int]] = [[] for _ in caches]
    n_parts = 0
    for pos, dev in enumerate(devices):
        held = [(r, assigns[r][pos]) for r in range(len(caches)) if pos in assigns[r]]
        if not held:
            continue
        # the device's n_valid and offset vectors: one upload for its slabs
        meta = np.zeros((2, sum(len(idxs) for _r, idxs in held)), dtype=np.int64)
        at = 0
        for r, idxs in held:
            nvs = np.array([caches[r].blocks[b].n_valid for b in idxs], dtype=np.int64)
            if keeps[r] is not None:
                nvs = np.where(keeps[r][idxs], nvs, 0)
            meta[0, at:at + len(idxs)], meta[1, at:at + len(idxs)] = nvs, offsets[r][idxs]
            at += len(idxs)
        meta_d = torch.from_numpy(meta).to(dev)
        tasks, at = [], 0
        for r, idxs in held:
            nb = len(idxs)
            data, nulls = pins[r][pos]
            descs = refs = None
            if plans is not None:
                descs, refs = plans[r].sig, tuple(int(x) for x in plans[r].refs)
            img = Image(list(data), list(nulls), meta_d[0, at:at + nb], nb, ev.block_rows, dev,
                        meta_d[1, at:at + nb], None, descs, refs)
            tasks.append(fused_batch.Task(progs[specs[r][1]], img, capacity))
            region_parts[r].append(n_parts)
            n_parts += 1
            at += nb
        device_tasks.append((pos, tasks))
    return (device_tasks, region_parts, specs, [progs[s[1]] for s in specs], prunes,
            plans is not None)


def launch_xregion_sharded(ev: TorchDagEvaluator, caches, mesh: TorchMesh) -> XRegionPending:
    """One aggregation plan over R filled region caches, spread over every
    device of ``mesh`` (``mesh.launch_xregion_sharded``, program #20).

    Each (region, block) is a slab on its owner device
    (:func:`slab_assignment`); a device's slabs of one region form one
    image, whose blocks keep their global row offsets in the region and ship
    ``n_valid`` 0 where zone maps prune them.  Per device, one batch
    (``fused_batch``: a task per region it holds, at the shared capacity of
    ``xregion_specs``) gives each region's partial state; ``mesh_merge``
    folds, region by region, the states of every device that holds a slab of
    it, in device order, into ``(R, li, C)`` / ``(R, lf, C)`` on the lead
    device, which :class:`XRegionPending` finalizes as the single-device
    batch does.  Encoded images ship encoded when ``encoding.batch_plan``
    finds them alike, run-length lanes excepted (they decline to a decoded
    ship, counted as ``rle_sharded``).

    ``ValueError`` for a plan that does not aggregate, has an aggregate
    without a merge rule, no regions, an empty cache, unstable group
    dictionaries, or where the batch kernels' limits refuse it."""
    device_tasks, region_parts, specs, progs, prunes, encoded = xshard_tasks(ev, caches, mesh)
    lead = mesh.lead
    states = [fused_batch.fused_batch(tasks) for _pos, tasks in device_tasks]
    parts = tuple(torch.cat([st[m].to(lead, non_blocking=True) for st in states])
                  for m in (0, 1))
    table = fused_mesh.merge_table(region_parts, parts[0].shape[0], lead)
    packed = fused_mesh.mesh_merge(progs[0], parts, table)
    return XRegionPending(ev, specs, progs, packed, list(range(len(caches))), prunes, encoded)


def run_xregion_sharded(ev: TorchDagEvaluator, caches, mesh: TorchMesh):
    """:func:`launch_xregion_sharded`, then ``finalize``."""
    return launch_xregion_sharded(ev, caches, mesh).finalize()
