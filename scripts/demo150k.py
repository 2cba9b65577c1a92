"""150k-color-regime demo: build a ~65k-genome block-structured corpus
(short genomes — structure matters, length doesn't), force the
no-dense-matrix regime, and run FI + TU through the runs paths on the GPU,
recording reads/s and peak host memory.

Usage: python scripts/demo150k.py [num_genomes]
"""

import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["FULGOR_DENSE_MAX_BYTES"] = "0"  # the regime under test

CACHE = os.path.join(REPO, "bench_cache")
N = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
K = 31


def main():
    import numpy as np

    from fulgor_tpu.build.builder import build_index
    from fulgor_tpu.index import Index
    from fulgor_tpu.io.simulate import (simulate_pangenome_blocks,
                                        simulate_reads, write_fastq)

    corpus = os.path.join(CACHE, f"big{N}")
    index_path = os.path.join(CACHE, f"big{N}.mini.tfur")
    reads = os.path.join(CACHE, f"big{N}_reads.fastq.gz")
    if not os.path.exists(index_path):
        t0 = time.perf_counter()
        paths = simulate_pangenome_blocks(
            corpus, N, num_genes=10, gene_len=330, core_frac=0.3,
            loss_rate=0.05, mut_per_branch=2, gain_per_branch=1,
            gain_len=330, pool_genes=400, seed=11, gzip_files=False)
        print(f"corpus: {len(paths)} genomes in "
              f"{time.perf_counter() - t0:.0f}s", flush=True)
        t0 = time.perf_counter()
        idx = build_index(paths, k=K, m=19, verbose=True)
        print(f"index built in {time.perf_counter() - t0:.0f}s", flush=True)
        idx.save(index_path)
    if not os.path.exists(reads):
        paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus)
                       if f.endswith(".fa") or f.endswith(".fa.gz"))
        codes, names = simulate_reads(paths[::256], 100_000, 150, seed=5)
        write_fastq(reads, codes, names)

    import jax

    from fulgor_tpu.compile_cache import enable_compile_cache
    from fulgor_tpu.query.engine import QueryEngine

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)

    idx = Index.load(index_path)
    nu = len(idx.unitig_offs) - 1
    print(f"index: {idx.num_kmers:,} kmers {idx.num_colors:,} colors "
          f"{idx.num_color_sets:,} sets {nu:,} unitigs "
          f"(words/set {idx.words_per_set})", flush=True)
    eng = QueryEngine(idx, batch_size=32768)
    assert eng.use_runs_fetch and eng.use_tu_runs, "not in the runs regime"
    print(f"paths: runs_fetch={eng.use_runs_fetch} tu_runs={eng.use_tu_runs} "
          f"probe={eng._pb}", flush=True)

    for label, kw in (("FI", {}), ("TU(0.8)", {"threshold": 0.8})):
        eng.pseudoalign_file(reads, "/dev/null", **kw)  # warm
        t0 = time.perf_counter()
        s = eng.pseudoalign_file(reads, "/dev/null", **kw)
        dt = time.perf_counter() - t0
        print(f"{label}: {s['num_reads'] / dt:,.0f} reads/s "
              f"(query {s['query_sec']:.2f}s host {s['host_sec']:.2f}s "
              f"redo {s['num_redo']}) mapped {s['num_mapped']}", flush=True)
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"peak host RSS: {rss_gib:.1f} GiB; dense matrix never "
          f"materialized: {idx._dense_bits is None}", flush=True)


if __name__ == "__main__":
    main()
