"""Segment directories carry data between the two packages.

(a) A baseballStats segment written by the JAX SegmentCreator loads in the
port with the same dictionaries, host arrays (SV, sorted ranges, MV, raw,
inverted index, bloom filter) and padded lanes, dtypes and padding values
included. (b) The port's SegmentCreator writes a directory the JAX loader
loads to the same arrays, and (c) its files are byte-identical to the JAX
creator's, apart from the creation time in metadata.json. (d) SSB
segments written by the JAX creator, each with the dictionaries it built
from its own rows, answer Q1.1-Q4.3 through the port's
QueryEngine.from_dirs as the JAX engine and the numpy oracle do (the
tolerances of test_torch_ssb.py).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from fixtures import build_segment, make_columns
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.segment.creator import SegmentCreator as JaxSegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu.tools import datagen as jax_datagen
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.tools import baseball
from pinot_tpu_torch.tools.ssb import (SSB_PQLS, canon_response, check,
                                       make_cpu_queries)

#: metadata.json fields that record when the segment was built
TIME_FIELDS = ("creationTimeMs",)


def _lane_kinds(cm):
    if not cm.has_dictionary:
        return ("raw",)
    if not cm.single_value:
        return ("mv",)
    if cm.data_type.np_dtype.kind in "iu":
        return ("ids", "parts")
    if cm.data_type.np_dtype.kind == "f":
        return ("ids", "vlane")
    return ("ids",)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "O" or b.dtype.kind == "O":
        assert a.tolist() == b.tolist(), what
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_segment(port_seg, jax_seg, lanes: bool = True):
    """The port's segment holds what the JAX segment holds."""
    assert port_seg.segment_name == jax_seg.segment_name
    assert port_seg.num_docs == jax_seg.num_docs
    assert port_seg.padded_docs == jax_seg.padded_docs
    assert sorted(port_seg.column_names) == sorted(jax_seg.column_names)
    for col in jax_seg.column_names:
        p, j = port_seg.data_source(col), jax_seg.data_source(col)
        assert p.metadata.to_json() == j.metadata.to_json(), col
        if j.dictionary is not None:
            assert p.dictionary.values.dtype == j.dictionary.values.dtype
            _equal(p.dictionary.values, j.dictionary.values, col)
        for attr in ("dict_ids", "mv_dict_ids", "raw_values",
                     "sorted_ranges"):
            jv, pv = getattr(j, attr), getattr(p, attr)
            assert (jv is None) == (pv is None), (col, attr)
            if jv is not None:
                assert pv.dtype == jv.dtype, (col, attr)
                _equal(pv, jv, f"{col}.{attr}")
        assert (j.inverted_index is None) == (p.inverted_index is None)
        if j.inverted_index is not None:
            _equal(p.inverted_index.docids, j.inverted_index.docids, col)
            _equal(p.inverted_index.offsets, j.inverted_index.offsets, col)
        assert (j.bloom_filter is None) == (p.bloom_filter is None)
        if j.bloom_filter is not None:
            assert p.bloom_filter.num_bits == j.bloom_filter.num_bits
            assert p.bloom_filter.num_hashes == j.bloom_filter.num_hashes
            _equal(p.bloom_filter.bits, j.bloom_filter.bits, col)
        if not lanes:
            continue
        for kind in _lane_kinds(j.metadata):
            got = p.host_operand(kind)
            want = j.host_operand(kind)
            if kind == "mv":
                # the port's MV lane is narrow; values and padding agree
                assert got.dtype.itemsize <= want.dtype.itemsize
                assert (got[j.mv_dict_ids.shape[0]:] ==
                        j.metadata.cardinality).all()
            else:
                assert got.dtype == want.dtype, (col, kind)
            _equal(got, want, f"{col} lane {kind}")
            dev = {"ids": p.device_dict_ids, "mv": p.device_mv_dict_ids,
                   "raw": p.device_raw_values, "parts": p.device_part_lanes,
                   "vlane": p.device_value_lane}[kind]()
            assert dev.device.type == "cpu"
            _equal(dev.numpy(), got, f"{col} device lane {kind}")


@pytest.mark.parametrize("n", [2_500, 10_000])
def test_jax_directory_loads_in_the_port(tmp_path, n):
    jax_seg, _cols = build_segment(str(tmp_path), n=n, seed=n)
    seg = ImmutableSegmentLoader.load(str(tmp_path), device="cpu")
    assert_same_segment(seg, jax_seg)


def _build_both(tmp_path, n, seed):
    """The same columns through both creators, into two directories."""
    cols = make_columns(n, seed)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    from fixtures import make_schema, make_table_config
    JaxSegmentCreator(make_schema(), make_table_config(),
                      segment_name="seg").build(dict(cols), jdir)
    SegmentCreator(baseball.make_schema(), baseball.make_table_config(),
                   segment_name="seg").build(dict(cols), pdir)
    return jdir, pdir


@pytest.mark.parametrize("n", [2_500, 10_000])
def test_port_directory_loads_in_jax(tmp_path, n):
    jdir, pdir = _build_both(tmp_path, n, seed=n + 1)
    from_port = JaxLoader.load(pdir)
    from_jax = JaxLoader.load(jdir)
    for col in from_jax.column_names:
        j, p = from_jax.data_source(col), from_port.data_source(col)
        assert p.metadata.to_json() == j.metadata.to_json(), col
        for kind in _lane_kinds(j.metadata):
            want, got = j.host_operand(kind), p.host_operand(kind)
            assert got.dtype == want.dtype
            _equal(got, want, f"{col} lane {kind}")
    # and the port's own loader reads it as it reads the JAX directory
    assert_same_segment(ImmutableSegmentLoader.load(pdir, device="cpu"),
                        from_jax, lanes=False)


@pytest.mark.parametrize("n", [2_500, 10_000])
def test_port_files_are_byte_identical(tmp_path, n):
    jdir, pdir = _build_both(tmp_path, n, seed=n + 2)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    assert "metadata.json" in names and len(names) > 20
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(pdir, name), "rb") as f:
            got = f.read()
        if name != "metadata.json":
            assert got == want, name
            continue
        jmeta, pmeta = json.loads(want), json.loads(got)
        for field in TIME_FIELDS:
            assert isinstance(pmeta.pop(field), int)
            jmeta.pop(field)
        assert pmeta == jmeta


@pytest.mark.parametrize("what", ["star-tree", "STRING"])
def test_creator_refuses_what_it_does_not_build(tmp_path, what):
    cfg = baseball.make_table_config()
    if what == "star-tree":
        cfg.indexing_config.star_tree_configs = [
            {"dimensionsSplitOrder": ["teamID"], "functionColumnPairs":
             ["SUM__runs"]}]
    else:            # a chunked raw string column
        cfg.indexing_config.no_dictionary_columns = ["salary", "teamID"]
    with pytest.raises(NotImplementedError, match=what):
        SegmentCreator(baseball.make_schema(), cfg).build(
            dict(make_columns(100, 0)), str(tmp_path))


# ---------------------------------------------------------------------------
# SSB from disk, per-segment dictionaries
# ---------------------------------------------------------------------------

SSB_ROWS, SSB_SEGMENTS, SSB_SEED = 200_000, 2, 4


@pytest.fixture(scope="module")
def ssb_engines(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ssb"))
    dirs, ids, supplycost = jax_datagen.build_ssb_segment_dirs(
        base, SSB_ROWS, SSB_SEGMENTS, SSB_SEED)
    port = QueryEngine.from_dirs(dirs, device="cpu")
    oracle = make_cpu_queries(jax_datagen.ssb_pools(SSB_SEED), ids,
                              supplycost)
    return JaxQueryEngine.from_dirs(dirs), port, oracle


@pytest.mark.parametrize("q", sorted(SSB_PQLS))
def test_ssb_from_disk_matches_jax_and_oracle(ssb_engines, q):
    jax_engine, port, oracle = ssb_engines
    jax_resp = jax_engine.query(SSB_PQLS[q])
    want = canon_response(q, jax_resp)
    resp = port.query(SSB_PQLS[q])
    assert not resp.exceptions
    got = canon_response(q, resp)
    if q.startswith("q1"):
        assert got == want
    else:
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k][0] == w[0], (q, k)
            if len(w) > 1:
                assert got[k][1] == pytest.approx(w[1], rel=1e-6), (q, k)
    expected = oracle[q]()
    if not q.startswith("q1"):
        for k, e in expected.items():
            if len(e) > 1:
                assert got[k][1] == pytest.approx(e[1], rel=1e-12), (q, k)
    check(q, got, expected)
    check(q, want, expected)
    assert resp.num_docs_scanned == jax_resp.num_docs_scanned
