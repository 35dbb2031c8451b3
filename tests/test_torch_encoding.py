"""Encoded images: the port's ``copr/encoding.py`` against the JAX package's.

The same blocks go through ``tikv_tpu.copr.encoding.encode_blocks`` and the
port's ``encode_blocks``; every column must come out encoded the same way
(kind, lane dtype, frame of reference, packed lanes, runs, run capacity,
narrowed codes, sorted dictionaries), on the lineitem fixture, on its
date-sorted variant (l_shipdate becomes RLE) and on a nullable table (all
NULL, mixed, runs of NULL, object BYTES of low and high cardinality).  The
device plans and stacked payloads agree too.  Program #1's plain version,
``kernels.decode_device_column``, equals the JAX package's on the non-NULL
slots and the NULL mask, and the host decode exactly.
"""

import numpy as np
import pytest
import torch

from tikv_tpu.copr import encoding as jenc
from tikv_tpu.copr import kernels as jkernels
from tikv_tpu.copr.cache import ColumnBlockCache as JaxCache
from tikv_tpu.copr.datatypes import Column as JaxColumn
from tikv_tpu.copr.datatypes import EvalType as JaxEvalType
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import encoding as penc
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.datatypes import Column, EvalType
from tikv_tpu_torch.copr.kernels import decode_device_column

INT, DEC, REAL, BYTES = "int", "decimal", "real", "bytes"


def _lineitem_blocks(a, block_rows):
    """The blocks of ``fixtures.build_cache`` over draws ``a``, as plain
    ``(eval_type value, data, nulls, frac, dictionary)`` columns."""
    n = len(a["qty"])
    dict_rf = np.empty(3, dtype=object)
    dict_rf[:] = [b"A", b"N", b"R"]
    dict_ls = np.empty(2, dtype=object)
    dict_ls[:] = [b"F", b"O"]
    out = []
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nz = np.zeros(e - s, dtype=bool)
        out.append(([(INT, np.arange(s, e, dtype=np.int64), nz, 0, None),
                     (INT, a["qty"][s:e], nz, 0, None),
                     (DEC, a["price"][s:e], nz, 2, None),
                     (DEC, a["disc"][s:e], nz, 2, None),
                     (INT, a["ship"][s:e], nz, 0, None),
                     (BYTES, a["rf"][s:e], nz, 0, dict_rf),
                     (BYTES, a["ls"][s:e], nz, 0, dict_ls)], e - s))
    return out


def _nullable_blocks(n=3000, block_rows=512):
    """Columns that exercise every rule: all NULL (one run), mixed NULLs
    (bitpack), runs with NULL runs (RLE), a wide DECIMAL (stays plain), REAL
    (plain), low-cardinality object BYTES with NULLs (sorted dictionary),
    high-cardinality object BYTES (stays object), int64 dictionary codes
    (narrowed), and a column RLE in some blocks and not others (bitpack)."""
    rng = np.random.default_rng(31)
    run_vals = np.repeat(rng.integers(-5, 5, n // 50 + 1), 50)[:n]
    run_nulls = np.repeat(rng.random(n // 50 + 1) < 0.3, 50)[:n]
    mixed = rng.integers(100, 200, n)
    mixed_nulls = rng.random(n) < 0.25
    wide = rng.integers(-(1 << 40), 1 << 40, n)
    reals = rng.normal(size=n)
    low = np.array([[b"x", b"yy", b"zzz"][i] for i in rng.integers(0, 3, n)], dtype=object)
    low_nulls = rng.random(n) < 0.1
    low[low_nulls] = b""
    high = np.array([b"k%05d" % i for i in rng.permutation(n)], dtype=object)
    codes_dict = np.empty(4, dtype=object)
    codes_dict[:] = [b"a", b"b", b"c", b"d"]
    codes = rng.integers(0, 4, n)
    half = np.where(np.arange(n) < n // 2, 7, rng.integers(0, 1000, n))
    out = []
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        m = e - s
        zero = np.zeros(m, dtype=bool)
        out.append(([(INT, np.arange(s, e, dtype=np.int64), zero, 0, None),
                     (INT, np.zeros(m, dtype=np.int64), np.ones(m, dtype=bool), 0, None),
                     (INT, np.where(mixed_nulls[s:e], 0, mixed[s:e]), mixed_nulls[s:e], 0, None),
                     (INT, np.where(run_nulls[s:e], 0, run_vals[s:e]), run_nulls[s:e], 0, None),
                     (DEC, wide[s:e], zero, 2, None),
                     (REAL, reals[s:e], zero, 0, None),
                     (BYTES, low[s:e], low_nulls[s:e], 0, None),
                     (BYTES, high[s:e], zero, 0, None),
                     (BYTES, codes[s:e], zero, 0, codes_dict),
                     (INT, half[s:e], zero, 0, None)], m))
    return out


def _tables():
    a = fx.build_arrays(6000, seed=11)
    big = fx.build_arrays(40000, seed=12)
    return {
        "lineitem": _lineitem_blocks(a, 1024),
        "lineitem_shipdate": _lineitem_blocks(fx.sort_by_shipdate(big), 1024),
        "nullable": _nullable_blocks(),
    }


_TABLES = {}


def _blocks(name):
    if not _TABLES:
        _TABLES.update(_tables())
    return _TABLES[name]


def _copy(arr):
    return arr.copy() if isinstance(arr, np.ndarray) else arr


def jax_cache(blocks, encode=True):
    cache = JaxCache()
    for cols, n_valid in blocks:
        cache.add([JaxColumn(JaxEvalType(et), _copy(d), _copy(nl), frac, dic)
                   for et, d, nl, frac, dic in cols], n_valid)
    cache.filled = True
    changed = jenc.encode_blocks(cache, None) if encode else {}
    return cache, changed


def port_cache(blocks, encode=True):
    cache = ColumnBlockCache.from_numpy_blocks(
        [([(et, _copy(d), _copy(nl), frac, dic) for et, d, nl, frac, dic in cols], n)
          for cols, n in blocks])
    changed = penc.encode_blocks(cache, None) if encode else {}
    return cache, changed


def _assert_same_column(j, p, jmod=jenc):
    """Column ``j`` (encoded by ``jmod``) and the port's ``p`` alike."""
    assert isinstance(j, jmod.EncodedColumn) == isinstance(p, penc.EncodedColumn)
    if isinstance(j, jmod.EncodedColumn):
        assert (j.kind, j.n, j.ref, j.k_cap) == (p.kind, p.n, p.ref, p.k_cap)
        if j.kind == "bp":
            assert j.packed.dtype == p.packed.dtype
            np.testing.assert_array_equal(j.packed, p.packed)
            np.testing.assert_array_equal(j._nulls, p._nulls)
        else:
            for name in ("run_values", "run_ends", "run_nulls"):
                jx, px = getattr(j, name), getattr(p, name)
                assert jx.dtype == px.dtype
                np.testing.assert_array_equal(jx, px)
        return
    jd, pd = np.asarray(j.data), np.asarray(p.data)
    assert jd.dtype == pd.dtype
    np.testing.assert_array_equal(jd, pd)
    np.testing.assert_array_equal(np.asarray(j.nulls), np.asarray(p.nulls))
    assert (j.dictionary is None) == (p.dictionary is None)
    if j.dictionary is not None:
        assert list(j.dictionary) == list(p.dictionary)


@pytest.mark.parametrize("table", ["lineitem", "lineitem_shipdate", "nullable"])
def test_encode_blocks_matches_the_jax_package_column_by_column(table):
    jc, jchanged = jax_cache(_blocks(table))
    pc, pchanged = port_cache(_blocks(table))
    assert jchanged == pchanged and pchanged
    assert jc.enc_version == pc.enc_version == 1
    for jb, pb in zip(jc.blocks, pc.blocks):
        for j, p in zip(jb.cols, pb.cols):
            _assert_same_column(j, p)
    # the shared dictionaries are one object per column across the image
    for ci in range(len(pc.blocks[0].cols)):
        dicts = {id(b.cols[ci].dictionary) for b in pc.blocks}
        assert len(dicts) == 1


def test_each_fixture_column_takes_its_expected_encoding():
    _jc, changed = port_cache(_blocks("lineitem"))
    assert changed == {0: "bp", 1: "bp", 2: "bp", 3: "bp", 4: "bp", 5: "code", 6: "code"}
    _jc, changed = port_cache(_blocks("lineitem_shipdate"))
    assert changed[4] == "rle"
    _jc, changed = port_cache(_blocks("nullable"))
    assert changed == {0: "bp", 1: "rle", 2: "bp", 3: "rle", 6: "dict", 8: "code", 9: "bp"}
    pc, _ = port_cache(_blocks("lineitem"))
    b0 = pc.blocks[0].cols
    assert [b0[i].packed.dtype for i in range(5)] == [np.int16, np.int8, np.int32, np.int8,
                                                    np.int16]
    assert b0[4].ref == 8400 and np.asarray(b0[5].data).dtype == np.int8


def test_fixtures_build_cache_encodes_like_encode_blocks():
    a = fx.build_arrays(5000, seed=11)
    built = fx.build_cache(5000, 1024, arrays=a, encode=True)
    pc, _ = port_cache(_lineitem_blocks(a, 1024))
    for bb, pb in zip(built.blocks, pc.blocks):
        for x, y in zip(bb.cols, pb.cols):
            _assert_same_column(x, y, penc)
    assert built.enc_version == 1 and all(b.zones for b in built.blocks)


def test_sort_by_shipdate_is_a_stable_permutation_of_the_draws():
    a = fx.build_arrays(3000, seed=2)
    s = fx.sort_by_shipdate(a)
    order = np.argsort(a["ship"], kind="stable")
    assert np.all(np.diff(s["ship"]) >= 0)
    for k in a:
        np.testing.assert_array_equal(s[k], a[k][order])


_PLANS = [([1, 2, 3, 4], []), ([0, 1, 2, 3, 4, 5, 6], [])]
_NULLABLE_PLANS = [([0, 1, 2, 3, 5, 8, 9], [1, 2, 3, 5, 8]), ([2, 3], [2, 3]),
                   ([4, 5], [5]), ([0], [])]


@pytest.mark.parametrize("table", ["lineitem", "lineitem_shipdate", "nullable"])
def test_device_plans_and_stacked_payloads_match_the_jax_package(table):
    jc, _ = jax_cache(_blocks(table))
    pc, _ = port_cache(_blocks(table))
    for ship, nullable in (_NULLABLE_PLANS if table == "nullable" else _PLANS):
        jp = jenc.device_plan(jc, ship, nullable)
        pp = penc.device_plan(pc, ship, nullable)
        assert (jp is None) == (pp is None)
        if pp is None:
            continue
        assert (jp.sig, jp.null_sig) == (pp.sig, pp.null_sig)
        np.testing.assert_array_equal(jp.refs, pp.refs)
        jd, jn, jr = jenc.stack_block_payloads(jc.blocks, ship, nullable, jp, 1024)
        pd, pn, pr = penc.stack_block_payloads(pc.blocks, ship, nullable, pp, 1024)
        np.testing.assert_array_equal(jr, pr)
        for x, y in zip(jd, pd):
            for xa, ya in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple)
                              else (y,)):
                assert xa.dtype == ya.dtype
                np.testing.assert_array_equal(xa, ya)
        for x, y in zip(jn, pn):
            np.testing.assert_array_equal(x, y)


def test_a_plain_image_has_no_device_plan():
    pc, _ = port_cache(_blocks("lineitem"), encode=False)
    assert penc.device_plan(pc, [1, 2, 3, 4], []) is None
    assert pc.enc_version == 0


@pytest.mark.parametrize("table", ["lineitem_shipdate", "nullable"])
def test_decode_device_column_matches_the_jax_package_and_the_host_decode(table):
    jc, _ = jax_cache(_blocks(table))
    pc, _ = port_cache(_blocks(table))
    rows = 1024 if table != "nullable" else 512
    checked = set()
    for jb, pb in zip(jc.blocks, pc.blocks):
        for j, p in zip(jb.cols, pb.cols):
            desc, ref = penc._col_desc(p)
            if desc[0] == "plain" or p.eval_type.value == "real":
                continue
            checked.add(desc[0])
            payload = penc.block_payload(p, rows)
            nulls = penc.block_null_payload(p, rows)
            want_d, want_n = jkernels.decode_device_column(np, jenc._col_desc(j)[0], payload,
                                                            nulls, ref, rows)
            t = tuple(torch.from_numpy(x) for x in payload) if isinstance(payload, tuple) \
                else torch.from_numpy(payload)
            got_d, got_n = decode_device_column(desc, t, torch.from_numpy(nulls), ref, rows)
            got_d, got_n = got_d.numpy(), got_n.numpy()
            np.testing.assert_array_equal(got_n, want_n)
            live = ~want_n
            np.testing.assert_array_equal(got_d[live], np.asarray(want_d)[live])
            assert not got_d[~live].any()  # NULL slots decode to 0
            n = len(p)
            np.testing.assert_array_equal(got_d[:n], penc.decoded_data(p))
            np.testing.assert_array_equal(got_n[:n], penc.decoded_nulls(p))
    assert checked == {"rle", "bp", "code"}


@pytest.mark.parametrize("case", fx.DECODE_CASES,
                         ids=[f"{k}-{np.dtype(t).name}-{n}" for k, t, n in fx.DECODE_CASES])
def test_decode_device_column_on_the_synthetic_cases_matches_the_jax_package(case):
    rows = 512
    desc, payload, nulls, ref = fx.synthetic_encoded_column(*case, 4, rows, seed=5)
    t = tuple(torch.from_numpy(x) for x in payload) if isinstance(payload, tuple) \
        else torch.from_numpy(payload)
    got_d, got_n = decode_device_column(desc, t, None if nulls is None else
                                        torch.from_numpy(nulls), ref, rows)
    for b in range(4):
        pb = tuple(x[b] for x in payload) if isinstance(payload, tuple) else payload[b]
        nb = np.zeros(rows, dtype=bool) if nulls is None else nulls[b]
        want_d, want_n = jkernels.decode_device_column(np, desc, pb, nb, ref, rows)
        gn = np.zeros(rows, dtype=bool) if got_n is None else got_n[b].numpy()
        np.testing.assert_array_equal(gn, want_n)
        np.testing.assert_array_equal(got_d[b].numpy()[~gn], np.asarray(want_d)[~gn])
        assert not got_d[b].numpy()[gn].any()


def test_encoded_columns_shadow_data_and_nulls_of_the_slotted_column():
    assert "data" in Column.__slots__ and "nulls" in Column.__slots__
    assert isinstance(penc.EncodedColumn.data, property)
    col = penc.EncodedColumn(EvalType.INT, 0, "bp", 3,
                             packed=np.array([1, 0, 2], dtype=np.int8), ref=10,
                             nulls=np.array([False, True, False]))
    assert not hasattr(col, "__dict__")
    np.testing.assert_array_equal(col.data, [11, 0, 12])
    np.testing.assert_array_equal(col.nulls, [False, True, False])
    taken = col.take(np.array([2, 1]))
    assert type(taken) is Column and list(taken.data) == [12, 0]


@pytest.mark.parametrize("table", ["lineitem_shipdate", "nullable"])
def test_take_slice_and_byte_accounting_match_the_jax_package(table):
    jc, _ = jax_cache(_blocks(table))
    pc, _ = port_cache(_blocks(table))
    rows = np.array([0, 3, 7, 100, 200, 300])
    for j, p in zip(jc.blocks[1].cols, pc.blocks[1].cols):
        assert jenc.column_nbytes(j) == penc.column_nbytes(p)
        assert jenc.column_decoded_nbytes(j) == penc.column_decoded_nbytes(p)
        jt, pt = j.take(rows), p.take(rows)
        np.testing.assert_array_equal(np.asarray(jt.data), np.asarray(pt.data))
        np.testing.assert_array_equal(np.asarray(jt.nulls), np.asarray(pt.nulls))
    jcols, jl = jenc.late_materialize_chunk(jc.blocks[1].cols, rows)
    pcols, pl = penc.late_materialize_chunk(pc.blocks[1].cols, rows)
    np.testing.assert_array_equal(jl, pl)
    for x, y in zip(jcols, pcols):
        np.testing.assert_array_equal(np.asarray(x.data), np.asarray(y.data))
    plain, _ = port_cache(_blocks(table), encode=False)
    cols, logical = penc.late_materialize_chunk(plain.blocks[1].cols, rows)
    assert cols is plain.blocks[1].cols and logical is rows


def test_widening_codes_bumps_the_version_and_drops_the_pins():
    jc, _ = jax_cache(_blocks("lineitem"))
    pc, _ = port_cache(_blocks("lineitem"))
    pc.device_arrays(pc.blocks[0], ("probe",), lambda _b: torch.zeros(4))
    before = penc.device_plan(pc, [5], []).sig
    assert not pc.widen_codes(5, 100)  # fits the int8 lanes already
    assert pc.widen_codes(5, 1000) and jenc.ensure_code_capacity(jc.blocks, 5, 1000)
    assert pc.enc_version == 2 and pc.device_nbytes() == 0
    assert penc.device_plan(pc, [5], []).sig != before
    for jb, pb in zip(jc.blocks, pc.blocks):
        _assert_same_column(jb.cols[5], pb.cols[5])
    assert np.asarray(pc.blocks[0].cols[5].data).dtype == np.int16


def test_column_descriptor_layout_matches_the_cuda_source():
    import re
    from pathlib import Path

    from tikv_tpu_torch.copr import fused_agg as fa

    text = (Path(fa.__file__).resolve().parent.parent / "csrc" / "fa_walk.cuh").read_text()
    kinds = {m.group(1): int(m.group(2)) for m in re.finditer(r"FA_ENC_(\w+) = (\d+)", text)}
    assert kinds == {"PLAIN": fa.ENC_PLAIN, "NARROW": fa.ENC_NARROW, "RLE": fa.ENC_RLE}
    body = text[text.index("struct FaEnc {"):]
    body = body[: body.index("};")]
    fields = re.findall(r"(\w+)\[FA_MAX_COLS\];", body)
    assert fields == [name for name, _t in fa._Enc._fields_]
