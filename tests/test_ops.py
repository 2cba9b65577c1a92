"""Device ops vs naive host oracles (reference §4 oracle pattern:
check_intersection / check_union, include/util.hpp:106-208)."""

import numpy as np
import pytest

from fulgor_tpu.build.builder import build_index
from fulgor_tpu.core import kmers as K
from fulgor_tpu.ops.pipeline import (
    query_full_intersection,
    query_threshold_union,
    query_window_csids,
)
from fulgor_tpu.query.host_lookup import lookup_host
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta

INVALID = 0xFFFFFFFF


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("ops")
    k = 15
    genomes = random_genomes(rng, num_colors=6, length=2000, mut=0.03, k=k)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa")
        write_fasta(p, seqs)
        paths.append(p)
    idx = build_index(paths, k=k, m=9, dict_kind="cuckoo")
    # reads: windows of genomes + mutations + random junk + Ns
    reads = []
    L = 60
    for _ in range(300):
        g = rng.integers(0, len(genomes))
        s = genomes[g][0]
        p = rng.integers(0, len(s) - L)
        r = list(s[p : p + L])
        for _ in range(rng.poisson(1.5)):
            r[rng.integers(0, L)] = "ACGTN"[rng.integers(0, 5)]
        reads.append("".join(r))
    for _ in range(30):
        reads.append(K.codes_to_seq(rng.integers(0, 4, size=L).astype(np.uint8)))
    reads.append("A" * (k - 1))  # shorter than k after padding -> no windows
    codes = np.full((len(reads), L), 4, dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = K.seq_to_codes(r)
    return idx, reads, codes, k


def naive_window_csids(idx, read, k):
    km, valid = K.pack_kmers(K.seq_to_codes(read), k)
    out = np.full(len(km), INVALID, dtype=np.uint32)
    if len(km) == 0:
        return out
    can = K.canonicalize(km, k)
    vals = lookup_host(idx.dict_table, can)  # table values ARE csids
    hit = valid & (vals != INVALID)
    out[hit] = vals[hit]
    return out


def test_window_csids_match_host(setup):
    idx, reads, codes, k = setup
    hit, csid, _ovf = map(np.asarray, query_window_csids(idx.dict_table, codes, k=k))
    W = codes.shape[1] - k + 1
    for i, read in enumerate(reads):
        expect = naive_window_csids(idx, read, k)
        expect_pad = np.full(W, INVALID, dtype=np.uint32)
        expect_pad[: len(expect)] = expect
        np.testing.assert_array_equal(csid[i], expect_pad, err_msg=f"read {i}")
        np.testing.assert_array_equal(hit[i], expect_pad != INVALID)


def test_full_intersection_matches_naive(setup):
    idx, reads, codes, k = setup
    cat, offs = idx.color_sets_decoded()
    bits = np.asarray(
        query_full_intersection(idx.dict_table, idx.dense_color_bits(), codes, k=k)[0]
    )
    for i, read in enumerate(reads):
        csids = naive_window_csids(idx, read, k)
        distinct = np.unique(csids[csids != INVALID])
        if len(distinct) == 0:
            expect = np.empty(0, dtype=np.uint32)
        else:
            acc = set(cat[offs[distinct[0]] : offs[distinct[0] + 1]])
            for sid in distinct[1:]:
                acc &= set(cat[offs[sid] : offs[sid + 1]])
            expect = np.array(sorted(acc), dtype=np.uint32)
        got = np.flatnonzero(np.unpackbits(bits[i].view(np.uint8), bitorder="little"))
        np.testing.assert_array_equal(got, expect, err_msg=f"read {i}")


@pytest.mark.parametrize("threshold", [0.8, 0.5, 1.0])
def test_threshold_union_matches_naive(setup, threshold):
    idx, reads, codes, k = setup
    cat, offs = idx.color_sets_decoded()
    scores, npos, _ovf = map(
        np.asarray,
        query_threshold_union(
            idx.dict_table, idx.dense_color_bits(), codes, k=k, num_colors=idx.num_colors
        ),
    )
    for i, read in enumerate(reads):
        csids = naive_window_csids(idx, read, k)
        pos = csids[csids != INVALID]
        exp_scores = np.zeros(idx.num_colors, dtype=np.int64)
        for sid in pos:
            exp_scores[cat[offs[sid] : offs[sid + 1]].astype(np.int64)] += 1
        np.testing.assert_array_equal(
            scores[i].astype(np.int64), exp_scores, err_msg=f"read {i}"
        )
        assert npos[i] == len(pos)
        # reference rule: min_score = floor(positives * tau); report >= min_score
        min_score = int(len(pos) * threshold)
        if len(pos) > 0:
            expect = np.flatnonzero(exp_scores >= min_score)
            got = np.flatnonzero(scores[i] >= min_score)
            np.testing.assert_array_equal(got, expect)


def test_compact_runs(setup):
    """compact_runs (used by the mesh path) must cover every positive window
    with duplicate-tolerant (csid, count) runs."""
    from fulgor_tpu.ops.intersect import compact_runs
    import jax.numpy as jnp

    idx, reads, codes, k = setup
    hit, csid, _ovf = map(
        np.asarray, query_window_csids(idx.dict_table, codes, k=k)
    )
    run_csid, run_cnt, ovf = map(
        np.asarray, compact_runs(jnp.asarray(hit), jnp.asarray(csid), 16)
    )
    assert not ovf.any()
    for i in range(len(reads)):
        pos = csid[i][hit[i]]
        # total multiplicity per csid matches
        exp = {}
        for s in pos:
            exp[int(s)] = exp.get(int(s), 0) + 1
        got = {}
        for s, c in zip(run_csid[i], run_cnt[i]):
            if s != INVALID:
                got[int(s)] = got.get(int(s), 0) + int(c)
        assert got == exp, f"read {i}"


def test_runs_strategy_large_colors(rng):
    """The color stage compacts runs before gathering at every C (round-3
    perf change); verify against naive on a synthetic large-C index, and
    the tight-budget dispatchers' overflow contract."""
    from fulgor_tpu.ops import intersect as I
    import jax.numpy as jnp

    C32 = 72
    S = I.ONEHOT_MAX_SETS + 100
    dense = rng.integers(0, 1 << 32, size=(S, C32), dtype=np.uint64).astype(np.uint32)
    B, W = 32, 40
    hit = rng.random((B, W)) < 0.8
    csid = rng.integers(0, S, size=(B, W)).astype(np.uint32)
    # adjacent runs: smear values to create realistic run structure
    for b in range(B):
        for w in range(1, W):
            if rng.random() < 0.7:
                csid[b, w] = csid[b, w - 1]
    run_csid, run_cnt, ovf = map(
        np.asarray, I.compact_runs(jnp.asarray(hit), jnp.asarray(csid), W)
    )
    assert not ovf.any()
    got = np.asarray(
        I.full_intersection_runs(
            jnp.asarray(dense), jnp.asarray(run_csid), jnp.asarray(hit.any(axis=1))
        )
    )
    for b in range(B):
        sids = np.unique(csid[b][hit[b]])
        if len(sids) == 0:
            expect = np.zeros(C32, dtype=np.uint32)
        else:
            expect = dense[sids[0]].copy()
            for s in sids[1:]:
                expect &= dense[s]
        np.testing.assert_array_equal(got[b], expect, err_msg=f"row {b}")

    # dispatcher overflow contract: with a tight budget, reads with more
    # runs than the budget must raise rovf; non-ovf reads exact
    from fulgor_tpu.ops.pipeline import _fi_dispatch, _tu_dispatch

    R = 16
    bits2, rovf = map(
        np.asarray, _fi_dispatch(jnp.asarray(dense), jnp.asarray(hit),
                                 jnp.asarray(csid), R))
    nruns = np.asarray(
        I.compact_runs(jnp.asarray(hit), jnp.asarray(csid), W)[0])
    nruns = (nruns != INVALID).sum(axis=1)
    np.testing.assert_array_equal(rovf, nruns > R)
    for b in np.flatnonzero(~rovf):
        np.testing.assert_array_equal(bits2[b], got[b], err_msg=f"fi row {b}")
    scores, rovf_tu = map(
        np.asarray, _tu_dispatch(jnp.asarray(dense), jnp.asarray(hit),
                                 jnp.asarray(csid), C32 * 32, R))
    np.testing.assert_array_equal(rovf_tu, nruns > R)
    bitsm = np.unpackbits(
        dense.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    for b in np.flatnonzero(~rovf_tu):
        exp = bitsm[csid[b][hit[b]].astype(np.int64)].sum(axis=0) \
            if hit[b].any() else np.zeros(C32 * 32, np.int64)
        np.testing.assert_array_equal(scores[b].astype(np.int64), exp,
                                      err_msg=f"tu row {b}")


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs too."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    found += _dot_precisions(sub)
    return found


@pytest.mark.parametrize("path", ["onehot", "windows", "runs"])
def test_count_matmuls_pinned_and_exact(path):
    """Every count matmul carries Precision.HIGHEST, and counts at the
    widest ladder rung (Wk = 1024 - 31 + 1 = 994 windows) equal numpy."""
    import jax
    from jax import lax

    from fulgor_tpu.ops import intersect as I

    rng = np.random.default_rng(4)
    B, Wk, S, C32 = 2, 994, 40, 3
    C = 32 * C32
    bits = rng.integers(0, 1 << 32, (S, C32), dtype=np.uint64).astype(np.uint32)
    bits[0] = 0xFFFFFFFF  # a set holding every color: its count reaches Wk
    member = np.unpackbits(bits.view(np.uint8), axis=1,
                           bitorder="little").astype(np.int64)  # (S, C)
    if path == "runs":
        R = 8
        rc = rng.integers(0, S, (B, R)).astype(np.uint32)
        rc[0] = 0
        cnt = np.full((B, R), Wk // R, np.int32)
        cnt[:, -1] += Wk - cnt.sum(axis=1)
        want = np.einsum("br,brc->bc", cnt.astype(np.int64), member[rc])
        fn, args = (lambda b, r, n: I.threshold_union_scores_runs(b, r, n, C),
                    (bits, rc, cnt))
    else:
        csid = rng.integers(0, S, (B, Wk)).astype(np.uint32)
        csid[0] = 0
        hit = np.ones((B, Wk), bool)
        hit[1, ::7] = False
        want = np.stack([member[csid[b][hit[b]]].sum(axis=0)
                         for b in range(B)])
        score = (I.threshold_union_scores_onehot if path == "onehot"
                 else I.threshold_union_scores_windows)
        fn, args = (lambda b, h, c: score(b, h, c, C), (bits, hit, csid))
    assert want.max() == Wk
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions and all(
        p == (lax.Precision.HIGHEST, lax.Precision.HIGHEST) for p in precisions)
    np.testing.assert_array_equal(np.asarray(fn(*args)), want)
    if path == "onehot":
        inter = np.stack([np.bitwise_and.reduce(bits[csid[b][hit[b]]], axis=0)
                          for b in range(B)])
        fi = lambda b, h, c: I.full_intersection_onehot(b, h, c)
        assert all(p == (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
                   for p in _dot_precisions(jax.make_jaxpr(fi)(*args).jaxpr))
        np.testing.assert_array_equal(np.asarray(fi(*args)), inter)
