#!/usr/bin/env python
"""Benchmark: pseudoalignment throughput at the baseline workload's shape.

Prints ONE JSON line:
  {"metric": "pseudoalign_reads_per_sec", "value": N, "unit": "reads/s",
   "vs_baseline": N / 50600, "corpus": "<name>"}

Baseline (BASELINE.md): the reference maps 6.58M real reads against its
4,546-genome Salmonella index (972k distinct color sets, 43.8M k-mers) at
19.76 us/read = ~50,600 reads/s with 8 CPU threads (README.md:171-177).

ORDERING CONTRACT (round-3 post-mortem: a 40-minute artifact build placed
before any measurement let the driver's timeout erase every number of the
round): corpora are measured CHEAPEST-FIRST, each immediately after its own
artifacts exist, and expensive artifact builds only start if the remaining
wall-clock budget (BENCH_BUDGET_SEC, default 3000 s) plausibly covers them.
The final JSON line reports the highest-priority corpus that got measured
(pansal4546 > pan1k > salmonella_10), even if later corpora were skipped
(skips are noted on stderr). The run exits non-zero when JAX finds no GPU
or any corpus failed.

Corpora:
  salmonella_10  10 real genomes (builds in ~1 min; round-1 continuity)
  pan1k          1,024 genomes x 300 kb scattered-SNP (shredded-graph
                 stress: no streaming locality; ~15M kmers, ~600k sets)
  pansal4546     PRIMARY: the baseline workload's published composition
                 AND structure (4,546 colors, ~44M kmers, ~1M distinct
                 sets, ~23 kmers/unitig streaming locality) via a
                 finite-accessory-gene-pool phylogeny simulator; see
                 docs/DESIGN-NOTES.md §16 for the calibration.

Artifacts are cached under bench_cache/ (corpus + indexes + simulated
FASTQ); later runs skip straight to the timed phase.
"""

import json
import os
import sys
import time

BASELINE_READS_PER_SEC = 50600.0
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_cache")
SALMONELLA_DIR = "/root/reference/test_data/salmonella_10"
NUM_READS = int(os.environ.get("BENCH_NUM_READS", "500000"))
READ_LEN = 150
K = 31

# pansal4546 simulator calibration (docs/DESIGN-NOTES.md §16): a finite
# accessory gene pool (gain/loss over a binary phylogeny) carries most
# distinct text in long blocks, with moderate per-branch SNPs landing
# mostly on accessory text; at 4,546 genomes the model lands on the
# reference's published index column (43.8M kmers / 4,546 colors / 972k
# sets / 23.3 kmers-per-unitig) within a few percent.
PANSAL = dict(num_genes=480, gene_len=2500, core_frac=0.6, loss_rate=0.03,
              mut_per_branch=65, ancestral_mut_frac=0.075,
              gain_per_branch=18, gain_len=2500, pool_genes=9000, seed=27)
PANSAL_GENOMES = 4546

# pan1k: scattered-SNP corpus — the shredded-graph stress case (no
# streaming locality; per-window color strategy).
PAN_GENOMES = 1024
PAN_LEN = 300_000
PAN_MUT = 300  # SNPs per tree branch (0.1%)

# rough cold-build wall-clock estimates (4-core host), used only to decide
# whether starting a build fits the remaining budget. pansal4546 measured
# round-4 at >2,700 s in re-parse mode; spill mode (now the build default)
# parses once instead of `passes` times — estimate still kept conservative
# until a cold spill build is timed.
EST_BUILD_SEC = {"salmonella_10": 180, "pan1k": 900, "pansal4546": 2100}


def _remaining(t_start, budget):
    return budget - (time.perf_counter() - t_start)


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def ensure_salmonella():
    os.makedirs(CACHE, exist_ok=True)
    index = os.path.join(CACHE, "salmonella_10.mini.tfur")
    reads = os.path.join(CACHE, f"reads_{NUM_READS}.fastq.gz")
    genomes = sorted(
        os.path.join(SALMONELLA_DIR, f)
        for f in os.listdir(SALMONELLA_DIR)
        if "fasta" in f
    )
    if not os.path.exists(index):
        from fulgor_tpu.build.builder import build_index

        _log("building salmonella_10 index...")
        idx = build_index(genomes, k=K, m=19)
        idx.save(index)
    if not os.path.exists(reads):
        from fulgor_tpu.io.simulate import simulate_reads, write_fastq

        _log(f"simulating {NUM_READS} salmonella reads...")
        codes, names = simulate_reads(genomes, NUM_READS, READ_LEN, seed=0)
        write_fastq(reads, codes, names)
    return index, reads


def ensure_pan1k():
    pan_dir = os.path.join(CACHE, "pan1k")
    index = os.path.join(CACHE, "pan1k.mini.tfur")
    reads = os.path.join(CACHE, f"pan1k_reads_{NUM_READS}.fastq.gz")
    if not os.path.exists(index):
        from fulgor_tpu.build.builder import build_index
        from fulgor_tpu.io.simulate import simulate_pangenome

        _log(f"generating pan1k corpus ({PAN_GENOMES} genomes x {PAN_LEN} bp)...")
        paths = simulate_pangenome(pan_dir, PAN_GENOMES, PAN_LEN, PAN_MUT, seed=3)
        _log("building pan1k index...")
        idx = build_index(paths, k=K, m=19, verbose=True)
        idx.save(index)
    if not os.path.exists(reads):
        from fulgor_tpu.io.simulate import simulate_reads, write_fastq

        pan_paths = sorted(
            os.path.join(pan_dir, f) for f in os.listdir(pan_dir)
            if f.endswith(".fa.gz")
        )
        _log(f"simulating {NUM_READS} pan1k reads...")
        codes, names = simulate_reads(pan_paths[::16], NUM_READS, READ_LEN, seed=1)
        write_fastq(reads, codes, names)
    return index, reads


def ensure_pansal():
    ps_dir = os.path.join(CACHE, "pansal4546")
    index = os.path.join(CACHE, "pansal4546.mini.tfur")
    reads = os.path.join(CACHE, f"pansal4546_reads_{NUM_READS}.fastq.gz")
    if not os.path.exists(index):
        from fulgor_tpu.build.builder import build_index
        from fulgor_tpu.io.simulate import simulate_pangenome_blocks

        _log(
            f"generating pansal4546 corpus ({PANSAL_GENOMES} genomes, "
            f"gene pool {PANSAL['pool_genes']} x {PANSAL['gain_len']} bp)..."
        )
        paths = simulate_pangenome_blocks(ps_dir, PANSAL_GENOMES, **PANSAL)
        _log("building pansal4546 index...")
        t0 = time.perf_counter()
        idx = build_index(paths, k=K, m=19, verbose=True)
        _log(f"pansal4546 index built in {time.perf_counter() - t0:.0f} s")
        idx.save(index)
    if not os.path.exists(reads):
        from fulgor_tpu.io.simulate import simulate_reads, write_fastq

        ps_paths = sorted(
            os.path.join(ps_dir, f) for f in os.listdir(ps_dir)
            if f.endswith(".fa.gz")
        )
        _log(f"simulating {NUM_READS} pansal4546 reads...")
        codes, names = simulate_reads(ps_paths[::64], NUM_READS, READ_LEN, seed=4)
        write_fastq(reads, codes, names)
    return index, reads


def _artifacts_ready(name):
    index = os.path.join(CACHE, f"{name}.mini.tfur")
    prefix = "" if name == "salmonella_10" else f"{name}_"
    reads = os.path.join(CACHE, f"{prefix}reads_{NUM_READS}.fastq.gz")
    return os.path.exists(index) and os.path.exists(reads)


def timed_pseudoalign(eng, reads_path, out_path, label, runs=3, threshold=None):
    stats = eng.pseudoalign_file(reads_path, out_path, threshold=threshold)  # warm
    elapsed = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        stats = eng.pseudoalign_file(reads_path, out_path, threshold=threshold)
        elapsed = min(elapsed, time.perf_counter() - t0)
    rps = stats["num_reads"] / elapsed
    _log(
        f"{label}: {stats['num_reads']} reads in {elapsed:.2f}s = "
        f"{rps:,.0f} reads/s (parse {stats['parse_sec']:.2f}s "
        f"query {stats['query_sec']:.2f}s host {stats.get('host_sec', 0.0):.2f}s "
        f"write {stats['write_sec']:.2f}s "
        f"redo {stats.get('num_redo', 0)} in {stats.get('redo_sec', 0.0):.2f}s); "
        f"mapped {stats['num_mapped']}"
    )
    return rps, stats


def measure_corpus(name, index_path, reads_path, out_path, tools=False,
                   on_fi=None):
    """Measure FI first; report it via on_fi IMMEDIATELY (so the primary
    JSON line is out before any tool compile can eat the budget), then
    run the non-flagship tools (stderr lines only)."""
    import numpy as np

    from fulgor_tpu.index import Index
    from fulgor_tpu.query.engine import QueryEngine

    idx = Index.load(index_path)
    nu = len(idx.unitig_offs) - 1
    _log(
        f"{name} index: {idx.num_kmers:,} kmers, {idx.num_colors} colors, "
        f"{idx.num_color_sets:,} distinct sets, {nu:,} unitigs "
        f"(kpu {idx.num_kmers / max(1, nu):.1f})"
    )
    eng = QueryEngine(idx, batch_size=32768)
    rps, _ = timed_pseudoalign(eng, reads_path, out_path,
                               f"{name} full-intersection")
    if on_fi is not None:
        on_fi(rps)
    if tools:
        for label, fn in [
            (f"{name} threshold-union(0.8)",
             lambda: eng.pseudoalign_file(reads_path, out_path, threshold=0.8)),
            (f"{name} kmer-conservation",
             lambda: eng.kmer_conservation_file(reads_path, out_path)),
            (f"{name} kmer-matches",
             lambda: eng.kmer_matches_file(reads_path, out_path)),
        ]:
            fn()  # warm (compile)
            t0 = time.perf_counter()
            s = fn()
            dt = time.perf_counter() - t0
            _log(f"{label}: {s['num_reads'] / dt:,.0f} reads/s")
    del eng, idx
    return rps


def _print_primary(results):
    """Emit the primary JSON line for the best corpus measured SO FAR.

    Called immediately after EVERY corpus measurement (round-4 post-mortem:
    the JSON used to print once at the end of main(), so a driver kill
    during a later corpus' artifact build erased numbers that had already
    been measured — twice). Re-printed as better corpora land; the driver
    parses the LAST line, so last-line-wins."""
    primary = next(
        (n for n in ("pansal4546", "pan1k", "salmonella_10") if n in results),
        None,
    )
    if primary is None:
        return
    rps = results[primary]
    print(json.dumps({
        "metric": "pseudoalign_reads_per_sec",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 3),
        "corpus": primary,
    }), flush=True)


def _ensure_built(name, t_start, budget):
    """Build a corpus' artifacts in a SUBPROCESS bounded by the remaining
    wall-clock budget (round-4 post-mortem: an under-estimated in-process
    build ran unbounded until the driver killed the whole bench). Returns
    True when the artifacts exist afterwards."""
    import subprocess

    if _artifacts_ready(name):
        return True
    rem = _remaining(t_start, budget)
    if rem < EST_BUILD_SEC[name] + 240:
        _log(
            f"skipping {name}: artifacts absent and remaining budget "
            f"{rem:.0f}s < estimated build {EST_BUILD_SEC[name]}s "
            f"(+measure); prebuild with scripts/prebuild_cache.py"
        )
        return False
    timeout = max(60.0, rem - 240)
    _log(f"building {name} artifacts in subprocess (timeout {timeout:.0f}s)...")
    try:
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--ensure", name],
            timeout=timeout,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
    except subprocess.TimeoutExpired:
        _log(f"{name} artifact build timed out after {timeout:.0f}s; skipping")
    return _artifacts_ready(name)


def main():
    t_start = time.perf_counter()
    budget = float(os.environ.get("BENCH_BUDGET_SEC", "3000"))

    import jax

    from fulgor_tpu.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")
    _log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    enable_compile_cache()

    # /dev/null output matches the baseline command exactly (README.md:171:
    # `fulgor pseudoalign ... -o /dev/null`): formatting is still fully
    # paid, the disk write is not part of either measurement.
    out_path = os.environ.get("BENCH_OUT", "/dev/null")

    results = {}  # corpus name -> reads/s (FI)
    tools_too = not os.environ.get("BENCH_PRIMARY_ONLY")

    # 1. salmonella_10: cheapest; always measured first so SOME number
    #    exists within minutes no matter what happens later.
    def _record(name):
        def on_fi(rps):
            results[name] = rps
            _print_primary(results)
        return on_fi

    failed = []
    try:
        index, reads = ensure_salmonella()
        measure_corpus("salmonella_10", index, reads, out_path,
                       tools=tools_too, on_fi=_record("salmonella_10"))
    except Exception as e:  # noqa: BLE001 - a broken corpus must not kill the rest
        _log(f"salmonella_10 FAILED: {e!r}")
        failed.append("salmonella_10")
        _print_primary(results)

    # 2/3. bigger corpora, cheapest-first; artifact builds run in a
    #      budget-bounded subprocess, and the primary JSON line re-prints
    #      the moment each corpus' FI number exists (before tools, whose
    #      compiles must never gate the primary metric; last line wins).
    for name, _ensure in (("pan1k", ensure_pan1k), ("pansal4546", ensure_pansal)):
        if not _ensure_built(name, t_start, budget):
            continue
        try:
            index, reads = _ensure()  # artifacts exist: returns paths only
            measure_corpus(name, index, reads, out_path,
                           tools=tools_too, on_fi=_record(name))
        except Exception as e:  # noqa: BLE001
            _log(f"{name} FAILED: {e!r}")
            failed.append(name)
            _print_primary(results)

    if failed or not results:
        sys.exit(f"bench.py: failed corpora {failed}; measured {sorted(results)}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ensure":
        {"salmonella_10": ensure_salmonella,
         "pan1k": ensure_pan1k,
         "pansal4546": ensure_pansal}[sys.argv[2]]()
    else:
        main()
