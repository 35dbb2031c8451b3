"""Vectorized group-dictionary encoding.

The port's own copy of ``tikv_tpu/copr/groupby.py``, key semantics unchanged.
Group-by keys are mapped to dense ids in **first-occurrence stream order**
(the CPU hash-agg's insertion order and the device path's group order both
come from here, which is what keeps their outputs byte-identical).

The per-block work is numpy: ``np.unique(return_inverse)`` gives block-local
codes, and only the (small) set of block-local uniques goes through the Python
dictionary, so cost per block is O(n log u) vectorized + O(u) interpreted —
not O(n) interpreted like a per-row dict loop.  Signed integer keys skip even
that: a sorted table of the keys seen maps a block's uniques to their ids by
binary search, and only keys new to the table touch the dictionary (a
high-cardinality GROUP BY, such as a supplier key, would otherwise spend
O(u) interpreted work on every block).
"""

from __future__ import annotations

import numpy as np


class GroupDict:
    """Incremental key→dense-id dictionary over column batches."""

    def __init__(self):
        self.index: dict = {}
        self.rows: list[tuple] = []  # gid -> key tuple (python values, None=NULL)
        # the integer keys of single-key batches, sorted, and their ids
        self._int_keys = np.empty(0, dtype=np.int64)
        self._int_ids = np.empty(0, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.rows)

    def assign(self, parts: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
        """parts: per group-expr (data, nulls) arrays over the SAME rows.
        Returns int64 gids aligned with those rows."""
        n = len(parts[0][0]) if parts else 0
        if n == 0:
            return np.empty(0, dtype=np.int64)
        if len(parts) == 1:
            return self._assign_single(*parts[0])
        return self._assign_tuple(parts)

    # -- single key, fully vectorized --------------------------------------

    def _assign_single(self, data: np.ndarray, nulls: np.ndarray) -> np.ndarray:
        if data.dtype == object:
            # NOTE: numpy 'S' arrays strip trailing NUL bytes (b"a" == b"a\x00"),
            # so bytes keys must stay object dtype; np.unique compares them as
            # python objects — slower, but exact
            arr = data
            if nulls.any():
                arr = data.copy()
                arr[nulls] = b""
        else:
            arr = data
        # block-local code: null rows get the dedicated slot len(uniq)
        uniq, inverse = np.unique(arr, return_inverse=True)
        codes = np.where(nulls, len(uniq), inverse)
        # map local code -> global gid, creating new gids in first-occurrence
        # order: the first row of each local code via one reversed fancy-store
        # (last write wins ⇒ smallest row index; avoids the slow .at ufuncs)
        n_local = len(uniq) + 1
        first_row = np.full(n_local, -1, dtype=np.int64)
        n = len(codes)
        first_row[codes[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
        if uniq.dtype.kind == "i":  # signed: every key fits the int64 table
            return self._int_ids_of(uniq, first_row)[codes]
        present = np.flatnonzero(first_row >= 0)
        order = present[np.argsort(first_row[present], kind="stable")]
        local_to_global = np.empty(n_local, dtype=np.int64)
        for lc in order:
            if lc == len(uniq):
                key = None
            else:
                v = uniq[lc]
                key = bytes(v) if isinstance(v, (bytes, np.bytes_)) else v.item()
            gid = self.index.get(key)
            if gid is None:
                gid = len(self.rows)
                self.index[key] = gid
                self.rows.append((key,))
            local_to_global[lc] = gid
        return local_to_global[codes]

    def _int_ids_of(self, uniq: np.ndarray, first_row: np.ndarray) -> np.ndarray:
        """``_assign_single``'s local-code -> id map for sorted signed integer
        ``uniq`` (local code ``len(uniq)``: NULL, present where its
        ``first_row`` is set), new keys taking ids in first-occurrence order,
        exactly as the dictionary loop gives them: table hits by binary
        search, the rest through ``index``."""
        n_u = len(uniq)
        out = np.empty(n_u + 1, dtype=np.int64)
        vals = uniq.astype(np.int64)
        pos = np.searchsorted(self._int_keys, vals)
        hit = pos < len(self._int_keys)
        hit[hit] = self._int_keys[pos[hit]] == vals[hit]
        out[:n_u][hit] = self._int_ids[pos[hit]]
        miss = np.flatnonzero(~np.append(hit, False) & (first_row >= 0))
        seen_keys, seen_ids = [], []
        for lc in miss[np.argsort(first_row[miss], kind="stable")].tolist():
            key = None if lc == n_u else int(vals[lc])
            gid = self.index.get(key)
            if gid is None:
                gid = len(self.rows)
                self.index[key] = gid
                self.rows.append((key,))
            out[lc] = gid
            if key is not None:
                seen_keys.append(key)
                seen_ids.append(gid)
        if seen_keys:
            keys = np.concatenate([self._int_keys, np.array(seen_keys, dtype=np.int64)])
            ids = np.concatenate([self._int_ids, np.array(seen_ids, dtype=np.int64)])
            by = np.argsort(keys, kind="stable")
            self._int_keys, self._int_ids = keys[by], ids[by]
        return out

    def assign_coded(
        self, codes: np.ndarray, nulls: np.ndarray, dictionary: np.ndarray
    ) -> np.ndarray:
        """Fast path for an already dictionary-encoded group column: codes are
        dense in [0, D), so no np.unique pass is needed — first-occurrence
        rows come from one reversed fancy-store (O(n), no .at ufuncs)."""
        n = len(codes)
        d = len(dictionary)
        local = np.where(nulls, d, codes).astype(np.int64)
        first_row = np.full(d + 1, -1, dtype=np.int64)
        # reversed store: the last write per slot is the smallest row index
        first_row[local[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
        present = np.flatnonzero(first_row >= 0)
        order = present[np.argsort(first_row[present], kind="stable")]
        local_to_global = np.empty(d + 1, dtype=np.int64)
        for lc in order:
            key = None if lc == d else bytes(dictionary[lc])
            gid = self.index.get(key)
            if gid is None:
                gid = len(self.rows)
                self.index[key] = gid
                self.rows.append((key,))
            local_to_global[lc] = gid
        return local_to_global[local]

    def assign_coded_multi(
        self, parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]]
    ) -> np.ndarray:
        """Composite key over multiple dictionary-encoded columns: fold the
        per-column codes into one dense product code (null gets a dedicated
        slot per column), then the single-code path.  Capacity is the product
        of dictionary sizes — callers gate on it staying small."""
        n = len(parts[0][0])
        local = np.zeros(n, dtype=np.int64)
        cap = 1
        for codes, nulls, dictionary in parts:
            d = len(dictionary)
            local = local * (d + 1) + np.where(nulls, d, codes)
            cap *= d + 1
        first_row = np.full(cap, -1, dtype=np.int64)
        first_row[local[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
        present = np.flatnonzero(first_row >= 0)
        order = present[np.argsort(first_row[present], kind="stable")]
        local_to_global = np.zeros(cap, dtype=np.int64)
        for lc in order:
            parts_key = []
            rem = int(lc)
            for codes, nulls, dictionary in reversed(parts):
                d = len(dictionary)
                c = rem % (d + 1)
                rem //= d + 1
                parts_key.append(None if c == d else bytes(dictionary[c]))
            key = tuple(reversed(parts_key))
            gid = self.index.get(key)
            if gid is None:
                gid = len(self.rows)
                self.index[key] = gid
                self.rows.append(key)
            local_to_global[lc] = gid
        return local_to_global[local]

    # -- composite key fallback --------------------------------------------

    def _assign_tuple(self, parts) -> np.ndarray:
        n = len(parts[0][0])
        gids = np.empty(n, dtype=np.int64)
        index = self.index
        rows = self.rows
        for i in range(n):
            key = tuple(
                None if nl[i] else (bytes(d[i]) if d.dtype == object else d[i].item())
                for d, nl in parts
            )
            gid = index.get(key)
            if gid is None:
                gid = len(rows)
                index[key] = gid
                rows.append(key)
            gids[i] = gid
        return gids
