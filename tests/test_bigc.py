"""150k-color regime: full intersection must run WITHOUT materializing the
dense (num_sets x C/32) matrix on host or device.

The runs-compacted FI fetch needs no color data on the device at all (the
probe ships distinct csids; the host decodes only the touched sets on
demand via Index.color_rows). This test grafts a synthetic 150,000-color
store onto a small real dBG and asserts (a) output equals the exact host
oracle and (b) dense_color_bits is never called.
"""

import dataclasses

import numpy as np
import pytest

from fulgor_tpu.core.colorstores import HybridStore
from fulgor_tpu.index import Index

BIG_C = 150_000


@pytest.fixture(scope="module")
def big_index(tmp_path_factory):
    from tests.test_mesh import K_LEN, random_genomes, write_fasta
    from fulgor_tpu.build.builder import build_index

    tmp = tmp_path_factory.mktemp("bigc")
    rng = np.random.default_rng(3)
    genomes = random_genomes(rng, num_colors=6, length=1200, mut=0.05, k=K_LEN)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa")
        write_fasta(p, seqs)
        paths.append(p)
    idx = build_index(paths, k=K_LEN, m=9)
    # graft a synthetic 150k-color store: same set COUNT (u2c stays valid),
    # arbitrary sorted member lists over the huge color space
    S = idx.num_color_sets
    sets = []
    for s in range(S):
        n = int(rng.integers(1, 400))
        sets.append(np.unique(rng.integers(0, BIG_C, n)).astype(np.uint32))
    cat = np.concatenate(sets)
    offs = np.concatenate([[0], np.cumsum([len(s) for s in sets])]).astype(np.int64)
    store = HybridStore.build(cat, offs, BIG_C)
    big = dataclasses.replace(
        idx,
        num_colors=BIG_C,
        filenames=[f"synthetic_{i}" for i in range(BIG_C)][:0],
        color_store=store,
        _dense_bits=None,
        _cs_cache=None,
        _row_memo=None,
        _row_pos=None,
        _row_n=0,
    )
    return tmp, big, genomes


def _write_reads(tmp_path, genomes, n=120, L=40, seed=4):
    rng = np.random.default_rng(seed)
    qfile = str(tmp_path / "reads.fq")
    reads = []
    with open(qfile, "w") as f:
        for i in range(n):
            g = genomes[rng.integers(0, len(genomes))][0]
            p = rng.integers(0, len(g) - L)
            s = g[p : p + L]
            reads.append(s)
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    return qfile, reads


def _forbid_dense(big):
    def boom():
        raise AssertionError("dense_color_bits materialized in the 150k regime")

    big.dense_color_bits = boom


@pytest.mark.parametrize("use_mesh", [False, True], ids=["1dev", "mesh8"])
def test_fi_150k_colors_without_dense_matrix(big_index, tmp_path, use_mesh,
                                             monkeypatch):
    """FI at 150k colors: single device AND the 8-device mesh must run the
    runs-fetch path with no dense matrix anywhere (the mesh composes
    with the large-C regime). The synthetic store is
    small in BYTES (few sets) so the engine's fits->materialize-up-front
    policy would otherwise build the dense matrix at init; force the
    dense-infeasible regime the real 150k corpus lives in."""
    from fulgor_tpu.query.engine import QueryEngine

    tmp, big, genomes = big_index
    monkeypatch.setenv("FULGOR_DENSE_MAX_BYTES", "0")
    qfile, reads = _write_reads(tmp_path, genomes)
    eng = QueryEngine(big, batch_size=64, use_mesh=use_mesh)
    assert eng.use_runs_fetch  # 150k colors = 4688 words >> threshold
    if use_mesh:
        assert eng.mesh is not None and eng._bits is None
    _forbid_dense(big)

    out = str(tmp_path / "psa.tsv")
    eng.pseudoalign_file(qfile, out)

    from fulgor_tpu.core import kmers as K

    got = {}
    for line in open(out):
        parts = line.split()
        got[int(parts[0])] = [int(c) for c in parts[2:]]
    assert len(got) == len(reads)
    for i, s in enumerate(reads):
        expect = eng._host_full_intersection(K.seq_to_codes(s))
        assert got[i] == list(map(int, expect)), f"read {i}"


@pytest.mark.parametrize("use_mesh", [False, True], ids=["1dev", "mesh8"])
def test_tu_150k_colors_without_dense_matrix(big_index, tmp_path, use_mesh,
                                             monkeypatch):
    """Threshold union at 150k colors: host scoring from (csid, count)
    runs, no dense matrix.
    The synthetic store is small in BYTES (few sets), so the dense
    feasibility gate is forced to the infeasible regime explicitly."""
    from fulgor_tpu.core import kmers as K
    from fulgor_tpu.query.engine import QueryEngine

    tmp, big, genomes = big_index
    monkeypatch.setenv("FULGOR_DENSE_MAX_BYTES", "0")
    qfile, reads = _write_reads(tmp_path, genomes, seed=9)
    eng = QueryEngine(big, batch_size=64, use_mesh=use_mesh)
    assert eng.use_tu_runs
    _forbid_dense(big)

    for tau in (0.8, 0.25):
        out = str(tmp_path / f"tu_{tau}.tsv")
        eng.pseudoalign_file(qfile, out, threshold=tau)
        got = {}
        for line in open(out):
            parts = line.split()
            got[int(parts[0])] = [int(c) for c in parts[2:]]
        assert len(got) == len(reads)
        for i, s in enumerate(reads):
            expect = eng._host_threshold(K.seq_to_codes(s), tau)
            assert got[i] == list(map(int, expect)), f"tau {tau} read {i}"
