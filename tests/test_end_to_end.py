"""End-to-end CLI tests: build -> query -> outputs, vs host oracles."""

import gzip
import os

import numpy as np
import pytest

from fulgor_tpu import cli
from fulgor_tpu.core import kmers as K
from fulgor_tpu.index import Index
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta

K_LEN = 15


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("e2e")
    genomes = random_genomes(rng, num_colors=5, length=1500, mut=0.03, k=K_LEN)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa.gz")
        write_fasta(p, seqs, gz=True)
        paths.append(p)
    listfile = str(tmp / "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(paths) + "\n")
    out_base = str(tmp / "idx")
    rc = cli.main(["build", "-l", listfile, "-o", out_base, "-k", str(K_LEN), "-m", "9", "--check"])
    assert rc == 0
    index_path = out_base + ".tfur"
    # reads
    reads = []
    L = 70
    for _ in range(200):
        g = rng.integers(0, len(genomes))
        s = genomes[g][0]
        p = rng.integers(0, len(s) - L)
        reads.append(s[p : p + L])
    reads.append(K.codes_to_seq(rng.integers(0, 4, size=L).astype(np.uint8)))  # junk
    qfile = str(tmp / "reads.fq.gz")
    with gzip.open(qfile, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i} comment\n{r}\n+\n{'I' * len(r)}\n")
    return tmp, index_path, qfile, reads, genomes


def test_pseudoalign_ascii(built, tmp_path):
    tmp, index_path, qfile, reads, genomes = built
    out = str(tmp_path / "out.tsv")
    rc = cli.main(["pseudoalign", "-i", index_path, "-q", qfile, "-o", out])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert len(lines) == len(reads)
    idx = Index.load(index_path)
    from fulgor_tpu.query.engine import QueryEngine

    eng = QueryEngine(idx)
    for ln in lines:
        parts = ln.split("\t")
        qid, n = int(parts[0]), int(parts[1])
        assert len(parts) == 2 + n
        cols = np.array(parts[2:], dtype=np.uint32)
        codes = K.seq_to_codes(reads[qid])
        expect = eng._host_full_intersection(codes)
        np.testing.assert_array_equal(cols, expect, err_msg=f"read {qid}")
        if n:
            assert (np.diff(cols.astype(np.int64)) > 0).all()


def test_pseudoalign_binary_matches_ascii(built, tmp_path):
    tmp, index_path, qfile, reads, _ = built
    out_a = str(tmp_path / "out.tsv")
    out_b = str(tmp_path / "out.bin")
    cli.main(["pseudoalign", "-i", index_path, "-q", qfile, "-o", out_a])
    cli.main(["pseudoalign", "-i", index_path, "-q", qfile, "-o", out_b, "--format", "binary"])
    buf = np.fromfile(out_b, dtype=np.uint32)
    recs = {}
    pos = 0
    while pos < len(buf):
        qid, n = int(buf[pos]), int(buf[pos + 1])
        recs[qid] = buf[pos + 2 : pos + 2 + n]
        pos += 2 + n
    for ln in open(out_a).read().splitlines():
        parts = ln.split("\t")
        qid, n = int(parts[0]), int(parts[1])
        np.testing.assert_array_equal(recs[qid], np.array(parts[2:], dtype=np.uint32))


def test_pseudoalign_compressed_roundtrip(built, tmp_path):
    """--format compressed decodes back to exactly the ascii lists
    (the reference's compressed output is a defined consumable artifact,
    src/ps_utils.cpp:149-243)."""
    from fulgor_tpu.query.formatters import read_compressed_psa

    tmp, index_path, qfile, reads, _ = built
    out_a = str(tmp_path / "out.tsv")
    out_c = str(tmp_path / "out.cpsa")
    cli.main(["pseudoalign", "-i", index_path, "-q", qfile, "-o", out_a])
    cli.main(["pseudoalign", "-i", index_path, "-q", qfile, "-o", out_c,
              "--format", "compressed"])
    idx = Index.load(index_path)
    num_colors, recs = read_compressed_psa(out_c)
    assert num_colors == idx.num_colors
    lines = open(out_a).read().splitlines()
    assert len(recs) == len(lines)
    for ln in lines:
        parts = ln.split("\t")
        qid, n = int(parts[0]), int(parts[1])
        np.testing.assert_array_equal(
            recs[qid], np.array(parts[2:], dtype=np.uint32), err_msg=f"read {qid}"
        )


def test_compressed_encodings_cover_all_branches(tmp_path):
    """Exercise every payload branch (empty/sparse/dense/complement) of the
    compressed format through a synthetic write + decode."""
    from fulgor_tpu.query.formatters import CompressedFormatter, read_compressed_psa
    from fulgor_tpu.core.hybrid import thresholds

    N = 64
    sparse_thr, dense_thr = thresholds(N)
    rng = np.random.default_rng(5)
    cases = [
        np.empty(0, dtype=np.uint32),                                   # empty
        np.sort(rng.choice(N, size=max(1, sparse_thr // 2), replace=False)).astype(np.uint32),
        np.sort(rng.choice(N, size=(sparse_thr + dense_thr) // 2, replace=False)).astype(np.uint32),
        np.sort(rng.choice(N, size=min(N - 1, dense_thr + 2), replace=False)).astype(np.uint32),
        np.arange(N, dtype=np.uint32),                                  # full (complement empty)
    ]
    path = str(tmp_path / "enc.cpsa")
    f = CompressedFormatter(path, N)
    f.write_batch(range(len(cases)), cases)
    # second flush frame: framing must survive multiple batches
    f.write_batch([len(cases)], [cases[1]])
    f.close()
    num_colors, recs = read_compressed_psa(path)
    assert num_colors == N and len(recs) == len(cases) + 1
    for i, c in enumerate(cases):
        np.testing.assert_array_equal(recs[i], c, err_msg=f"case {i}")
    np.testing.assert_array_equal(recs[len(cases)], cases[1])


def test_pseudoalign_threshold(built, tmp_path):
    tmp, index_path, qfile, reads, _ = built
    out = str(tmp_path / "out_thr.tsv")
    rc = cli.main(["pseudoalign", "-i", index_path, "-q", qfile, "-o", out, "-r", "0.8"])
    assert rc == 0
    idx = Index.load(index_path)
    from fulgor_tpu.query.engine import QueryEngine

    eng = QueryEngine(idx)
    for ln in open(out).read().splitlines():
        parts = ln.split("\t")
        qid = int(parts[0])
        cols = np.array(parts[2:], dtype=np.uint32)
        expect = eng._host_threshold(K.seq_to_codes(reads[qid]), 0.8)
        np.testing.assert_array_equal(cols, expect, err_msg=f"read {qid}")


def test_kmer_conservation(built, tmp_path):
    tmp, index_path, qfile, reads, _ = built
    out = str(tmp_path / "kc.tsv")
    rc = cli.main(["kmer-conservation", "-i", index_path, "-q", qfile, "-o", out])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert len(lines) == len(reads)
    # validate first mapped read's triples against host csids
    idx = Index.load(index_path)
    from fulgor_tpu.query.engine import QueryEngine, conservation_runs

    eng = QueryEngine(idx)
    for ln in lines[:20]:
        parts = ln.split("\t")
        name, n = parts[0], int(parts[1])
        qid = int(name.replace("read", ""))
        csid = eng._host_csids(K.seq_to_codes(reads[qid]))
        hit = csid != 0xFFFFFFFF
        expect = conservation_runs(hit, csid)
        assert n == len(expect)
        got = [tuple(map(int, t.strip("()").split())) for t in parts[2:]]
        assert got == expect


def test_kmer_matches(built, tmp_path):
    tmp, index_path, qfile, reads, _ = built
    out = str(tmp_path / "km.tsv")
    rc = cli.main(["kmer-matches", "-i", index_path, "-q", qfile, "-o", out])
    assert rc == 0
    lines = open(out).read().splitlines()
    idx = Index.load(index_path)
    assert lines[0] == f"num_colors={idx.num_colors}"
    assert len(lines) == len(reads) + 1
    from fulgor_tpu.query.engine import QueryEngine

    eng = QueryEngine(idx)
    cat, offs = idx.color_sets_decoded()
    for ln in lines[1:10]:
        parts = ln.split("\t")
        name, nk = parts[0], int(parts[1])
        qid = int(name.replace("read", ""))
        csid = eng._host_csids(K.seq_to_codes(reads[qid]))
        hit = csid != 0xFFFFFFFF
        assert nk == len(csid)
        bits = np.array(parts[2 : 2 + nk], dtype=np.int64)
        np.testing.assert_array_equal(bits, hit.astype(np.int64))
        counts = np.array(parts[2 + nk :], dtype=np.int64)
        expect = np.zeros(idx.num_colors, dtype=np.int64)
        for sid in csid[hit]:
            expect[cat[offs[sid] : offs[sid + 1]].astype(np.int64)] += 1
        np.testing.assert_array_equal(counts, expect)


def test_stats_verify_dump_load(built, tmp_path, capsys):
    tmp, index_path, qfile, reads, _ = built
    assert cli.main(["stats", "-i", index_path]) == 0
    assert cli.main(["verify", "-i", index_path]) == 0
    assert cli.main(["print-filenames", "-i", index_path]) == 0
    capsys.readouterr()
    base = str(tmp_path / "dumpbase")
    assert cli.main(["dump", "-i", index_path, "-o", base]) == 0
    out2 = str(tmp_path / "fromdump")
    assert cli.main(["load", "-i", base, "-o", out2, "-m", "9"]) == 0
    idx1 = Index.load(index_path)
    idx2 = Index.load(out2 + ".tfur")
    np.testing.assert_array_equal(idx1.u2c_csid, idx2.u2c_csid)
    np.testing.assert_array_equal(idx1.color_store.stream, idx2.color_store.stream)
    assert cli.main(["check", "-i", out2 + ".tfur"]) == 0


def test_pseudoalign_deduplicate(built, tmp_path):
    tmp, index_path, qfile, reads, _ = built
    out_a = str(tmp_path / "plain.tsv")
    out_d = str(tmp_path / "dedup.tsv")
    assert cli.main(["pseudoalign", "-i", index_path, "-q", qfile, "-o", out_a]) == 0
    assert cli.main(
        ["pseudoalign", "-i", index_path, "-q", qfile, "-o", out_d, "--deduplicate"]
    ) == 0
    # line SETS must match; order may differ (overflow/long reads are
    # appended at the end of the non-dedup stream, reference README.md:220
    # makes no ordering promise either)
    assert sorted(open(out_a).read().splitlines()) == sorted(
        open(out_d).read().splitlines()
    )


def test_lists_path_equals_dense(built, tmp_path):
    """The device-side list-compaction fetch (use_lists, normally active
    only past LISTS_MIN_WORDS colors) must produce byte-identical output to
    the dense-row fetch, for both FI and TU, including the over-T selective
    row fetch path."""
    import fulgor_tpu.query.engine as E
    from fulgor_tpu.query.engine import QueryEngine

    tmp, index_path, qfile, reads, _ = built
    idx = Index.load(index_path)
    dense = QueryEngine(idx, use_mesh=False)
    lists = QueryEngine(idx, use_mesh=False)
    assert not lists.use_lists  # small index: off by default
    lists.use_lists = True
    old_T = E.T_LIST
    E.T_LIST = 3  # tiny cap so the over-T row-fetch path actually runs
    try:
        for kw in ({}, {"threshold": 0.8}):
            o1 = str(tmp_path / "dense.tsv")
            o2 = str(tmp_path / "lists.tsv")
            dense.pseudoalign_file(qfile, o1, **kw)
            lists.pseudoalign_file(qfile, o2, **kw)
            assert open(o1).read() == open(o2).read(), f"mismatch for {kw}"
    finally:
        E.T_LIST = old_T


def test_runs_fetch_equals_dense(built, tmp_path):
    """The runs-compacted FI fetch (distinct csids + host dedup-intersect)
    and the device-thresholded TU bitmap fetch — normally active only past
    RUNS_FETCH_MIN_WORDS colors — must produce byte-identical output to the
    dense-row fetch."""
    from fulgor_tpu.query.engine import QueryEngine

    tmp, index_path, qfile, reads, _ = built
    idx = Index.load(index_path)
    dense = QueryEngine(idx, use_mesh=False)
    runs = QueryEngine(idx, use_mesh=False)
    assert not runs.use_runs_fetch  # small index: off by default
    runs.use_runs_fetch = True
    for kw in ({}, {"threshold": 0.8}):
        o1 = str(tmp_path / "dense.tsv")
        o2 = str(tmp_path / "runs.tsv")
        dense.pseudoalign_file(qfile, o1, **kw)
        runs.pseudoalign_file(qfile, o2, **kw)
        # byte-identical: every fetch strategy redoes overflow/long reads
        # INLINE, so output is strictly in read-id order
        assert open(o1).read() == open(o2).read(), f"mismatch for {kw}"


def test_runs_overflow_host_fallback(built, tmp_path, monkeypatch):
    """When the per-read run budget actually overflows (forced tiny here),
    the INLINE exact redo must recover those reads: output byte-identical
    to the dense-path golden for pseudoalign AND kmer-conservation (the
    redo merges results back in read-id order), and stats must show the
    redo really fired."""
    from fulgor_tpu.query import engine as E
    from fulgor_tpu.query.engine import QueryEngine

    tmp, index_path, qfile, reads, _ = built
    idx = Index.load(index_path)

    # pseudoalign: budget 2 distinct run-csids per read -> most reads ovf
    golden = QueryEngine(idx, use_mesh=False)
    o1 = str(tmp_path / "dense.tsv")
    s0 = golden.pseudoalign_file(qfile, o1)
    # the dense path may redo a FEW reads (trimmed main probe budgets
    # raise ovf for multi-candidate windows; the redo is exact), never many
    assert s0["num_redo"] <= 20, s0
    monkeypatch.setattr(E, "RUNS_FI_BUDGET", 2)
    eng = E.QueryEngine(idx, use_mesh=False)
    eng.use_runs_fetch = True
    o2 = str(tmp_path / "runs_ovf.tsv")
    s1 = eng.pseudoalign_file(qfile, o2)
    assert s1["num_redo"] > 0, "overflow never fired"
    assert open(o1).read() == open(o2).read()

    # kmer-conservation: same discipline via its per-width run budget
    k1 = str(tmp_path / "kc_golden.tsv")
    golden.kmer_conservation_file(qfile, k1)
    monkeypatch.setattr(E, "_runs_budget", lambda W, ekpu=64.0, k=31: 2)
    eng2 = E.QueryEngine(idx, use_mesh=False)
    k2 = str(tmp_path / "kc_ovf.tsv")
    s2 = eng2.kmer_conservation_file(qfile, k2)
    assert s2["num_redo"] > 0, "kc overflow never fired"
    assert open(k1).read() == open(k2).read()


def test_long_reads_and_long_names(built, tmp_path):
    """Reads wider than the stream ladder take the exact ragged host
    fallback (never a dense whole-file re-parse), and 200+ char FASTQ
    headers survive kc/km output intact."""
    tmp, index_path, qfile, reads, genomes = built
    from fulgor_tpu.query.engine import MAX_STREAM_WIDTH, QueryEngine, conservation_runs

    rng = np.random.default_rng(5)
    long_seq = genomes[0][0]
    while len(long_seq) <= MAX_STREAM_WIDTH:
        long_seq = long_seq + genomes[0][0]
    names = [
        "short0",
        "verylong_" + "n" * 220,
        "short1",
    ]
    seqs = [reads[0], long_seq, reads[1]]
    qf = str(tmp_path / "mixed.fq")
    with open(qf, "w") as f:
        for nm, s in zip(names, seqs):
            f.write(f"@{nm} c\n{s}\n+\n{'I' * len(s)}\n")

    idx = Index.load(index_path)
    eng = QueryEngine(idx)

    out = str(tmp_path / "psa.tsv")
    assert cli.main(["pseudoalign", "-i", index_path, "-q", qf, "-o", out]) == 0
    lines = sorted(open(out).read().splitlines(), key=lambda l: int(l.split("\t")[0]))
    assert len(lines) == 3
    for qid, s in enumerate(seqs):
        expect = eng._host_full_intersection(K.seq_to_codes(s))
        got = [int(x) for x in lines[qid].split("\t")[2:]]
        assert got == sorted(expect.tolist()), f"read {qid}"

    out = str(tmp_path / "kc.tsv")
    assert cli.main(["kmer-conservation", "-i", index_path, "-q", qf, "-o", out]) == 0
    got_lines = {l.split("\t")[0]: l for l in open(out).read().splitlines()}
    assert set(got_lines) == set(names)
    for nm, s in zip(names, seqs):
        csid = eng._host_csids(K.seq_to_codes(s))
        hit = csid != 0xFFFFFFFF
        expect = conservation_runs(hit, csid)
        parts = got_lines[nm].split("\t")
        assert int(parts[1]) == len(expect)
        assert [tuple(map(int, t.strip("()").split())) for t in parts[2:]] == expect

    out = str(tmp_path / "km.tsv")
    assert cli.main(["kmer-matches", "-i", index_path, "-q", qf, "-o", out]) == 0
    km_lines = open(out).read().splitlines()
    assert km_lines[0] == f"num_colors={idx.num_colors}"
    assert {l.split("\t")[0] for l in km_lines[1:]} == set(names)


def test_force_and_check_against(built, tmp_path):
    tmp, index_path, qfile, reads, genomes = built
    # --force: a second build into the same basename must refuse without it
    listfile = str(tmp / "list.txt")
    out_base = index_path[: -len(".tfur")]
    assert cli.main(["build", "-l", listfile, "-o", out_base, "-k", str(K_LEN), "-m", "9"]) == 1
    # meta-diff conversion + unitig-level cross-check against the base
    assert cli.main(["color", "-i", index_path, "--meta", "--diff", "--force"]) == 0
    md_path = out_base + ".tmdfur"
    assert cli.main(["check", "-i", md_path, "--against", index_path]) == 0
    # stats must print the per-store breakdown without error
    assert cli.main(["stats", "-i", md_path]) == 0
