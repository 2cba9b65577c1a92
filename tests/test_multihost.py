"""Multi-host scale-out: chunk sharding, id-global fragments, merge.

The sharding layer is process-count-agnostic host logic, so the sim-mode
test runs every shard pass in ONE process and must reproduce the
single-host output exactly — the same property a real N-process run has
(each process executes exactly one of these passes). A separate opt-in
test exercises real jax.distributed bring-up with two CPU processes.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from fulgor_tpu import cli
from fulgor_tpu.core import kmers as K
from fulgor_tpu.index import Index
from fulgor_tpu.query.engine import QueryEngine
from fulgor_tpu.parallel import multihost as MH
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta

K_LEN = 15


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    rng = np.random.default_rng(23)
    tmp = tmp_path_factory.mktemp("mh")
    genomes = random_genomes(rng, num_colors=6, length=1600, mut=0.03, k=K_LEN)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa.gz")
        write_fasta(p, seqs, gz=True)
        paths.append(p)
    listfile = str(tmp / "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(paths) + "\n")
    out_base = str(tmp / "idx")
    rc = cli.main(["build", "-l", listfile, "-o", out_base,
                   "-k", str(K_LEN), "-m", "9"])
    assert rc == 0
    # reads: several engine chunks at batch_size=64, plus a junk read and
    # a long read (>1024) whose host-redo line must merge back in order
    reads = []
    L = 70
    for _ in range(300):
        g = rng.integers(0, len(genomes))
        s = genomes[g][0]
        p = rng.integers(0, len(s) - L)
        reads.append(s[p: p + L])
    reads.append(K.codes_to_seq(rng.integers(0, 4, size=L).astype(np.uint8)))
    long_src = genomes[0][0]
    reads.append((long_src * 2)[:1400])
    qfile = str(tmp / "reads.fq.gz")
    with gzip.open(qfile, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i}\n{r}\n+\n{'I' * len(r)}\n")
    return tmp, out_base + ".tfur", qfile, len(reads)


@pytest.mark.parametrize("fmt", ["ascii", "binary", "compressed"])
def test_shard_passes_merge_to_single_host_output(built, tmp_path, fmt):
    tmp, index_path, qfile, n_reads = built
    idx = Index.load(index_path)
    eng = QueryEngine(idx, batch_size=64, use_mesh=False)

    single = str(tmp_path / f"single.{fmt}")
    stats1 = eng.pseudoalign_file(qfile, single, fmt=fmt)
    assert stats1["num_reads"] == n_reads

    P = 3
    parts = []
    own_total = 0
    for p in range(P):
        part = str(tmp_path / f"out.{fmt}.part{p}")
        st = eng.pseudoalign_file(qfile, part, fmt=fmt, shard=(p, P))
        assert st["num_reads_total"] == n_reads
        own_total += st["num_reads"]
        parts.append(part)
    assert own_total == n_reads  # shards partition the file
    merged = str(tmp_path / f"merged.{fmt}")
    MH.merge_fragments(parts, merged, fmt)

    if fmt == "ascii":
        s = sorted(open(single, "rb").readlines())
        m = open(merged, "rb").readlines()
        ids = [int(ln.split(b"\t", 1)[0]) for ln in m]
        assert ids == sorted(ids) and len(ids) == n_reads
        assert sorted(m) == s
    elif fmt == "binary":
        def recs(p):
            return {q: r for q, r in MH._iter_binary_records(p)}
        assert recs(merged) == recs(single)
    else:
        from fulgor_tpu.query.formatters import read_compressed_psa

        nc1, r1 = read_compressed_psa(single)
        nc2, r2 = read_compressed_psa(merged)
        assert nc1 == nc2 and set(r1) == set(r2)
        for q in r1:
            np.testing.assert_array_equal(r1[q], r2[q])


def test_single_proc_multihost_degenerates(built, tmp_path):
    tmp, index_path, qfile, n_reads = built
    idx = Index.load(index_path)
    eng = QueryEngine(idx, batch_size=64, use_mesh=False)
    out = str(tmp_path / "out.tsv")
    stats = MH.pseudoalign_multihost(eng, qfile, out, num_procs=1, proc_id=0)
    assert stats["num_reads"] == n_reads
    assert len(open(out, "rb").readlines()) == n_reads


_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
from fulgor_tpu.compile_cache import enable_compile_cache
enable_compile_cache()
index_path, qfile, out, coord, pid, np_ = sys.argv[1:7]
from fulgor_tpu.parallel import multihost as MH
MH.init_multihost(coord, int(np_), int(pid))
from fulgor_tpu.index import Index
from fulgor_tpu.query.engine import QueryEngine
eng = QueryEngine(Index.load(index_path), batch_size=64, use_mesh=False)
MH.pseudoalign_multihost(eng, qfile, out)
"""


@pytest.mark.skipif(
    os.environ.get("FULGOR_SKIP_MULTIHOST") == "1",
    reason="real 2-process jax.distributed bring-up skipped by env",
)
def test_two_process_jax_distributed(built, tmp_path):
    tmp, index_path, qfile, n_reads = built
    out = str(tmp_path / "mh.tsv")
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, index_path, qfile, out,
             coord, str(p), "2"],
            env={**os.environ, "XLA_FLAGS": ""},
        )
        for p in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=600) == 0
    lines = open(out, "rb").readlines()
    assert len(lines) == n_reads
    ids = [int(ln.split(b"\t", 1)[0]) for ln in lines]
    assert ids == sorted(ids)


@pytest.mark.parametrize("fmt", ["ascii", "binary", "compressed"])
def test_streaming_merge_large_fragments(tmp_path, fmt):
    """The k-way merge streams: fragments far larger than any in-RAM
    buffer budget (200k records across 3 parts + straggler side files)
    merge id-ordered and content-complete. Peak RSS is not asserted (too
    platform-dependent) but the readers are sequential-only — a whole-
    fragment materialization would be O(total), this is O(parts)."""
    from fulgor_tpu.query.formatters import make_formatter, read_compressed_psa

    rng = np.random.default_rng(5)
    P, N, C = 3, 200_000, 64
    expect = {}
    parts = []
    for p in range(P):
        ids = np.arange(p, N, P, dtype=np.int64)
        # ~1% stragglers diverted to the .redo side fragment, ascending
        straggle = np.zeros(len(ids), dtype=bool)
        straggle[rng.random(len(ids)) < 0.01] = True
        part = str(tmp_path / f"big.{fmt}.part{p}")
        parts.append(part)
        main = make_formatter(fmt, part, C)
        redo = make_formatter(fmt, part + ".redo", C)
        lists = []
        for q in ids:
            n = int(rng.integers(0, 6))
            cols = np.sort(rng.choice(C, size=n, replace=False)).astype(np.uint32)
            lists.append(cols)
            expect[int(q)] = cols
        m = ~straggle
        main.write_batch([int(q) for q in ids[m]],
                         [lists[i] for i in np.flatnonzero(m)])
        redo.write_batch([int(q) for q in ids[straggle]],
                         [lists[i] for i in np.flatnonzero(straggle)])
        main.close()
        redo.close()
    merged = str(tmp_path / f"big.{fmt}.merged")
    MH.merge_fragments(parts, merged, fmt)
    if fmt == "ascii":
        got_ids = []
        for qid, ln in MH._iter_ascii_records(merged):
            got_ids.append(qid)
            body = ln.rstrip(b"\n").split(b"\t")
            np.testing.assert_array_equal(
                np.array(body[2:], dtype=np.uint32), expect[qid])
    elif fmt == "binary":
        got_ids = []
        for qid, rec in MH._iter_binary_records(merged):
            got_ids.append(qid)
            np.testing.assert_array_equal(
                np.frombuffer(rec, dtype=np.uint32)[2:], expect[qid])
    else:
        _nc, recs = read_compressed_psa(merged)
        got_ids = sorted(recs)
        for q, cols in recs.items():
            np.testing.assert_array_equal(cols, expect[q])
    assert got_ids == list(range(N))
