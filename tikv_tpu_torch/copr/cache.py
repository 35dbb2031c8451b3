"""Columnar block cache: decoded blocks plus their device-resident images.

The port's subset of ``tikv_tpu/copr/cache.py:61``.  A cache holds the
column blocks of one (range, version), plain or encoded
(``copr/encoding.py``); any query over it skips scan and decode, and the
device path pins each plan signature's tensors on the evaluator's device on
first use, so steady-state queries move no bytes from the host.  Each block
also carries its zone maps (``copr/zone_maps.py``), built at encode time or
on first prune.  A write-through delta that changes rows in place patches
the pinned stacked lanes on their device (:meth:`ColumnBlockCache.scatter_update`,
the kernel of ``copr/fused_patch.py``).  The observatory's HBM gauges are not
ported.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .datatypes import Column, EvalType

# per-block pinned signatures (stacked image + n_valids) that may coexist
_MAX_DEVICE_SIGS = 6


@dataclass
class _Block:
    cols: list  # list[Column] (host)
    n_valid: int
    device: dict = field(default_factory=dict)  # sig -> pinned tensors
    # per-column prune statistics (zone_maps.build_block_zones); None until built
    zones: dict | None = None


class ColumnBlockCache:
    """Column blocks for one (range, version) — build once, evaluate many."""

    def __init__(self):
        self.blocks: list[_Block] = []
        self.filled = False
        # bumped whenever column encodings change (encoding.encode_blocks,
        # widen_codes, demote_column): encoded pin signatures include it
        self.enc_version = 0
        # bumped whenever host values change in place (scatter_update): the
        # evaluators' memos of zone-map decisions key on it
        self.data_version = 0
        self._mu = threading.Lock()

    @classmethod
    def from_numpy_blocks(cls, blocks) -> "ColumnBlockCache":
        """A filled cache from plain numpy blocks: ``blocks`` is a list of
        ``(columns, n_valid)``, each column ``(eval_type value, data, nulls,
        frac, dictionary)``.  This is how a decoded image built elsewhere
        (for example another package's cache) is carried into the port."""
        cache = cls()
        for columns, n_valid in blocks:
            cols = [
                Column(EvalType(et), np.asarray(data), np.asarray(nulls, dtype=bool),
                       int(frac), dictionary)
                for et, data, nulls, frac, dictionary in columns
            ]
            cache.add(cols, int(n_valid))
        cache.filled = True
        return cache

    def add(self, cols, n_valid: int) -> None:
        self.blocks.append(_Block(cols, n_valid))

    @property
    def total_rows(self) -> int:
        return sum(b.n_valid for b in self.blocks)

    def device_arrays(self, block: _Block, sig: tuple, build):
        """Device tensors for a plan signature, pinned on first use.  Bounded
        per block: once ``_MAX_DEVICE_SIGS`` signatures accumulate, the least
        recently used is dropped."""
        with self._mu:
            hit = block.device.get(sig)
            if hit is not None:
                block.device.pop(sig)  # touch for LRU order
                block.device[sig] = hit
                return hit
        built = build(block)
        with self._mu:
            block.device.setdefault(sig, built)
            while len(block.device) > _MAX_DEVICE_SIGS:
                block.device.pop(next(iter(block.device)))
            return block.device[sig]

    def drop_device(self) -> None:
        """Unpin every device copy; the host blocks stay."""
        with self._mu:
            for b in self.blocks:
                b.device.clear()

    def clear_blocks(self) -> None:
        """Drop every block and its pinned device copies."""
        self.drop_device()
        self.blocks.clear()
        self.data_version += 1

    def scatter_update(self, updates: dict) -> None:
        """Patch the pinned device tensors in place after an in-place host
        update (``tikv_tpu/copr/cache.py:186``).  ``updates``: block index
        -> (row positions, {column index: (values, nulls)}); the host
        columns already hold the new values.

        Every pin lives on ``blocks[0]`` (``device_arrays``).  Each
        ``("stacked", ship, nullable, block_rows, device)`` pin is patched
        on its own device by one ``patch_stacked`` launch (the plain version
        for CPU pins); ``nvoff`` stays (row counts do not change); every
        other pin (encoded stacks, zone layouts, mesh slabs) is dropped and
        rebuilds from the updated host blocks when next used.  Each updated
        block's zone maps widen with the new values first
        (``zone_maps.fold_update``), so the next prune sees them."""
        from . import fused_patch, zone_maps

        with self._mu:
            for bi, (_rows, cols) in updates.items():
                zone_maps.fold_update(self.blocks[bi].zones, cols)
            self.data_version += 1
            if not self.blocks or not updates:
                return
            pins = self.blocks[0].device
            for sig in list(pins):
                if sig[0] == "nvoff":
                    continue
                if sig[0] == "stacked":
                    fused_patch.patch_stacked(*fused_patch.pin_updates(pins[sig], sig, updates))
                else:
                    pins.pop(sig)

    def widen_codes(self, ci: int, max_code: int) -> bool:
        """Widen column ``ci``'s narrowed dictionary codes image-wide so
        ``max_code`` fits (``encoding.ensure_code_capacity``).  A change
        bumps ``enc_version`` and drops the pins: the next query pins the
        wider lanes."""
        from .encoding import ensure_code_capacity

        if not self.blocks or not ensure_code_capacity(self.blocks, ci, max_code):
            return False
        self.enc_version += 1
        self.drop_device()
        return True

    def nvoff_device(self, device):
        """``(n_valids, offsets)`` int64 ``[n_blocks]`` tensors on ``device``,
        pinned on first use (``jax_eval._nvoff_device``): each block's valid
        rows and the global row index of its row 0, which the grouped kernels'
        first-row tracker needs."""
        blocks = self.blocks

        def build(_blk):
            nv = np.array([b.n_valid for b in blocks], dtype=np.int64)
            off = np.concatenate([[0], np.cumsum(nv)[:-1]]).astype(np.int64)
            return torch.from_numpy(nv).to(device), torch.from_numpy(off).to(device)

        return self.device_arrays(blocks[0], ("nvoff", str(device)), build)

    def device_nbytes(self) -> int:
        """Bytes currently pinned on devices for this cache."""

        def nbytes(entry) -> int:
            if isinstance(entry, (tuple, list)):
                return sum(nbytes(e) for e in entry)
            if hasattr(entry, "tensors"):  # a pinned zone layout (copr/zone.py)
                return nbytes(entry.tensors())
            return entry.numel() * entry.element_size() if isinstance(entry, torch.Tensor) else 0

        with self._mu:
            return sum(nbytes(e) for b in self.blocks for e in b.device.values())
