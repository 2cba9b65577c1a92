#!/usr/bin/env python
"""fulgor-tpu end to end on one NVIDIA GPU: the quickest proof that the
system still starts and answers exactly on the card.

    python chip_smoke.py           one GPU, every phase below
    python chip_smoke.py --four    four GPUs: the mesh path only

One process, the only JAX process on the card. Phases, in order; any
failure stops the run with a non-zero exit and no result line:

  device    JAX must report platform "gpu" (never falls back to the CPU).
            Prints the card's name and power limit as nvidia-smi gives
            them, device_kind, the JAX version and bytes_limit.
  corpora   three corpora generated from seeds by fulgor_tpu/io/simulate.py
            and built through the CLI, each steering the engine to another
            color strategy: clonal10 (<=2048 sets: one-hot matmul), pan1k
            (~596k sets, 1,024 colors: dense per-window gather) and
            pansal4546 (4,546 colors: runs fetch + TU bitmap).
  queries   per corpus 65,536 simulated 150 bp reads (two full 32,768-read
            batches, so two dispatches are in flight) plus one 2,000 bp read,
            one random junk read and one header of more than 250
            characters; FI, TU(0.8), kmer-conservation and kmer-matches run
            through fulgor_tpu.cli with output to files.
  checks    FI and TU run with FULGOR_SELFCHECK=64, which compares sampled
            reads with the engine's exact host mirror byte for byte; kc and
            km outputs are compared line for line with >=512 sampled reads
            recomputed from the host mirror. Zero tolerance.
  compile   compiled.memory_analysis() of each corpus' FI, TU and km graphs
            at the bench shape (B=32768, W=160) and at the widest ladder
            rung, and of the one-hot graph at S=2048, whose (B, W, S+1)
            compare must fuse into its reduction.

The last stdout line is {"ok": true, "device": {...}} and nothing else.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import jax
import numpy as np

from fulgor_tpu import cli
from fulgor_tpu.compile_cache import enable_compile_cache
from fulgor_tpu.constants import INVALID_U32
from fulgor_tpu.index import Index
from fulgor_tpu.native import lib as native
from fulgor_tpu.io.simulate import (
    load_genome_codes,
    simulate_pangenome,
    simulate_pangenome_blocks,
    simulate_reads,
)
from fulgor_tpu.ops import pipeline as PL
from fulgor_tpu.ops.intersect import ONEHOT_MAX_SETS
from fulgor_tpu.query import engine as E

from bench import (  # corpus shapes shared with the bench
    PAN_GENOMES,
    PAN_LEN,
    PAN_MUT,
    PANSAL,
    PANSAL_GENOMES,
)

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_work")
K, M = 31, 19
READ_LEN = 150
NUM_READS = 65_536          # two full 32,768-read batches
BATCH = 32_768
LONG_READ_LEN = 2_000
SELFCHECK_PERIOD = 64
HOST_SAMPLE = 600           # kc/km reads recomputed on the host (+ extras)
BENCH_W = 160               # ladder rung of a 150 bp read

# clonal10: ten 2 Mb genomes down a 4-level tree at pan1k's SNP rate
# (0.1% per branch): <=1024 distinct sets, long unitigs.
CLONAL = dict(num_genomes=10, genome_len=2_000_000, mut_per_branch=2_000,
              seed=5)

# pansal4546 is cut in genes per genome only: the full corpus (~2.5 Mb per
# genome, 11 Gb of text) builds for ~30 min, past this script's 1200 s
# limit. Gene count, accessory pool, gains and SNPs per branch all shrink
# by PANSAL_GENE_CUT, so the per-bp SNP rate, the gene length, the loss
# rate and the 4,546 colors stay as published. On one H100 host the whole
# script took 596 s at a cut of 8 (pansal generated in 33 s, built in
# 45 s); 4 doubles that corpus and keeps the run well inside the limit,
# 2 would leave no margin for a slower host.
PANSAL_GENE_CUT = 4


def pansal_cut(cut: int) -> dict:
    p = dict(PANSAL)
    for key in ("num_genes", "pool_genes", "gain_per_branch", "mut_per_branch"):
        p[key] = max(1, round(PANSAL[key] / cut))
    return p


def log(msg: str = ""):
    print(msg, flush=True)


# ------------------------------------------------------------------ device

def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


def check_device(devices):
    """The first device must be a GPU; -> that device. Exits otherwise."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found {dev.platform} "
            f"({dev.device_kind})")
    return dev


def device_phase(want_count: int):
    dev = check_device(jax.devices())
    n = len(jax.devices())
    if n < want_count:
        raise SystemExit(f"need {want_count} GPUs, JAX found {n}")
    log(nvidia_smi())
    log(f"device_kind: {dev.device_kind} x{n}")
    log(f"jax {jax.__version__}")
    log(f"bytes_limit: {dev.memory_stats()['bytes_limit']}")
    return dev


# ------------------------------------------------------------------ corpora

def corpus_genomes(name: str, out_dir: str) -> list[str]:
    if name == "clonal10":
        return simulate_pangenome(out_dir, CLONAL["num_genomes"],
                                  CLONAL["genome_len"],
                                  CLONAL["mut_per_branch"],
                                  seed=CLONAL["seed"])
    if name == "pan1k":
        return simulate_pangenome(out_dir, PAN_GENOMES, PAN_LEN, PAN_MUT,
                                  seed=3)
    if name == "pansal4546":
        return simulate_pangenome_blocks(out_dir, PANSAL_GENOMES,
                                         **pansal_cut(PANSAL_GENE_CUT))
    raise ValueError(name)


CORPORA = ("clonal10", "pan1k", "pansal4546")
# genomes the reads are sampled from, and the read seed (bench.py's)
READ_SOURCE = {"clonal10": (1, 0), "pan1k": (16, 1), "pansal4546": (64, 4)}


def build_index_cli(genome_paths: list[str], base: str) -> tuple[str, float]:
    """`fulgor-tpu build` in-process; -> (index path, seconds)."""
    listfile = base + ".list.txt"
    with open(listfile, "w") as f:
        f.write("\n".join(genome_paths) + "\n")
    t0 = time.perf_counter()
    rc = cli.main(["build", "-l", listfile, "-o", base, "-k", str(K),
                   "-m", str(M)])
    if rc != 0:
        raise SystemExit(f"build of {base} failed (exit {rc})")
    return base + ".tfur", time.perf_counter() - t0


def write_reads(genome_paths: list[str], n: int, seed: int, path: str,
                long_len: int = LONG_READ_LEN):
    """n simulated READ_LEN reads + one long read, one junk read and one
    >250-char header, as FASTQ. -> [(name, codes u8)] in file order."""
    codes, names = simulate_reads(genome_paths, n, READ_LEN, seed=seed)
    reads = [(nm, codes[i]) for i, nm in enumerate(names)]
    rng = np.random.default_rng(seed + 1000)
    g = load_genome_codes(genome_paths[0])
    for _ in range(10_000):
        p = int(rng.integers(0, len(g) - long_len))
        seg = g[p: p + long_len]
        if (seg != 4).all():
            break
    else:
        raise SystemExit(f"no {long_len} bp window in {genome_paths[0]}")
    reads.append((f"long.{long_len}bp", seg.copy()))
    reads.append(("junk", rng.integers(0, 4, READ_LEN).astype(np.uint8)))
    reads.append(("longheader_" + "h" * 250, codes[0].copy()))
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    with open(path, "wb") as f:
        for nm, c in reads:
            f.write(b"@%s comment\n%s\n+\n%s\n"
                    % (nm.encode(), lut[c].tobytes(), b"I" * len(c)))
    return reads


# ------------------------------------------------------------------ queries

def run_cli(argv: list[str], env: dict | None = None) -> tuple[str, float]:
    """fulgor_tpu.cli in-process with stdout captured (and echoed
    indented); -> (stdout, seconds)."""
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dt = time.perf_counter() - t0
    out = buf.getvalue()
    for ln in out.splitlines():
        log(f"    {ln}")
    if rc != 0:
        raise SystemExit(f"{' '.join(argv[:1])} failed (exit {rc})")
    return out, dt


def engine_flags(eng) -> dict:
    return dict(one_hot=eng.idx.num_color_sets <= ONEHOT_MAX_SETS,
                use_lists=eng.use_lists, use_runs_fetch=eng.use_runs_fetch,
                use_tu_bits=eng.use_tu_bits, use_tu_runs=eng.use_tu_runs,
                color_runs=eng._color_runs(BENCH_W))


def count_lines(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f)


def query_fi_tu(index: str, reads_path: str, out: str, n_reads: int,
                threshold=None, batch: int = BATCH) -> int:
    """FI (threshold None) or TU through the CLI under FULGOR_SELFCHECK;
    -> reads the selfcheck compared with the host mirror."""
    argv = ["pseudoalign", "-i", index, "-q", reads_path, "-o", out,
            "--verbose", "--batch-size", str(batch)]
    if threshold is not None:
        argv += ["-r", str(threshold)]
    text, dt = run_cli(argv, {"FULGOR_SELFCHECK": str(SELFCHECK_PERIOD)})
    m = re.search(r"selfcheck: (\d+) sampled reads equal the host mirror", text)
    if m is None or int(m.group(1)) == 0:
        raise SystemExit(f"{out}: no selfcheck report")
    lines = count_lines(out)
    if lines != n_reads:
        raise SystemExit(f"{out}: {lines} lines for {n_reads} reads")
    return int(m.group(1))


def host_kc_line(eng, name: str, codes: np.ndarray) -> str:
    csid = eng._host_csids(codes)
    triples = E.conservation_runs(csid != INVALID_U32, csid)
    return name + f"\t{len(triples)}" + "".join(
        f"\t({p} {n} {i})" for p, n, i in triples)


def host_km_line(eng, name: str, codes: np.ndarray) -> str:
    csid = eng._host_csids(codes)
    hit = csid != INVALID_U32
    cat, offs = eng.idx.color_sets_decoded()
    counts = np.zeros(eng.idx.num_colors, dtype=np.int64)
    for sid in csid[hit]:
        counts[cat[offs[sid]: offs[sid + 1]].astype(np.int64)] += 1
    return (f"{name}\t{len(csid)}\t"
            + "\t".join(map(str, hit.astype(np.int64)))
            + "\t" + "\t".join(map(str, counts)))


def sample_reads(reads: list, n_sim: int) -> list:
    """~HOST_SAMPLE evenly spaced simulated reads plus every extra read."""
    step = max(1, n_sim // HOST_SAMPLE)
    return [reads[i] for i in range(0, n_sim, step)] + reads[n_sim:]


def check_host_lines(eng, out: str, sample: list, expect_line,
                     header: str | None = None) -> int:
    """Compare the output lines of the sampled reads with the host
    mirror's; -> reads compared."""
    want = {nm: c for nm, c in sample}
    got = {}
    with open(out) as f:
        if header is not None:
            first = f.readline().rstrip("\n")
            if first != header:
                raise SystemExit(f"{out}: header {first!r} != {header!r}")
        for ln in f:
            nm = ln.split("\t", 1)[0]
            if nm in want:
                got[nm] = ln.rstrip("\n")
    bad = [nm for nm, c in want.items()
           if got.get(nm) != expect_line(eng, nm, c)]
    if bad:
        raise SystemExit(f"{out}: {len(bad)} of {len(want)} sampled reads "
                         f"differ from the host mirror, e.g. {bad[0][:40]}")
    return len(want)


def query_phase(eng, name: str, index: str, reads_path: str, reads: list,
                n_sim: int, work: str, batch: int = BATCH) -> dict:
    """FI, TU(0.8), kc and km on one corpus through the CLI, each checked
    against the host mirror of `eng` (an engine on the same index);
    -> {tool: (seconds, reads checked)}."""
    log(f"engine {name}: {json.dumps(engine_flags(eng))}")
    n = len(reads)
    res = {}
    out = os.path.join(work, f"{name}.out")
    for tool, thr in (("FI", None), ("TU(0.8)", 0.8)):
        t0 = time.perf_counter()
        checked = query_fi_tu(index, reads_path, out, n, thr, batch)
        res[tool] = (time.perf_counter() - t0, checked)
    sample = sample_reads(reads, n_sim)
    for tool, cmd, line, header in (
            ("kc", "kmer-conservation", host_kc_line, None),
            ("km", "kmer-matches", host_km_line,
             f"num_colors={eng.idx.num_colors}")):
        _, dt = run_cli([cmd, "-i", index, "-q", reads_path, "-o", out,
                         "--batch-size", str(batch)])
        lines = count_lines(out) - (header is not None)
        if lines != n:
            raise SystemExit(f"{tool}: {lines} lines for {n} reads")
        res[tool] = (dt, check_host_lines(eng, out, sample, line, header))
    os.remove(out)
    for tool, (dt, checked) in res.items():
        log(f"query {name} {tool}: {dt:.1f} s incl. compile; {checked} reads "
            f"checked against the host mirror, 0 differ")
    return res


# ------------------------------------------------------------------ compile

def step_graphs(eng, B: int, W: int) -> dict:
    """The jitted FI / TU(0.8) / km steps the engine dispatches for a
    (B, W) stream batch, with their arguments (abstract read buffers)."""
    k, Wk = eng.k, W - eng.k + 1
    codes2 = jax.ShapeDtypeStruct((B, W // 4), np.uint8)
    bad = jax.ShapeDtypeStruct((B, W // 8), np.uint8)
    C = eng.idx.num_colors
    common = dict(k=k, width=W, dparams=eng.dparams, probe_budget=eng._pb)
    cr = eng._color_runs(W)
    R = min(eng._runs_R, Wk) if eng._runs_ok else Wk
    if eng.use_runs_fetch and not eng.use_lists:
        fi = (PL.query_distinct_runs_packed, (eng.table, codes2, bad),
              dict(common, R=R))
    elif eng.use_lists:
        fi = (PL.query_fi_lists_packed, (eng.table, eng.bits, codes2, bad),
              dict(common, T=E.T_LIST, color_runs=cr))
    else:
        fi = (PL.query_full_intersection_packed,
              (eng.table, eng.bits, codes2, bad), dict(common, color_runs=cr))
    if eng.use_tu_runs and not eng.use_lists:
        tu = (PL.query_runs_tu_packed, (eng.table, codes2, bad),
              dict(common, R=R))
    elif eng.use_tu_bits or eng.use_lists:
        tu = (PL.query_tu_lists_packed,
              (eng.table, eng.bits, codes2, bad, eng._minscore_tab(0.8, Wk)),
              dict(common, num_colors=C, T=E.T_LIST, color_runs=cr))
    else:
        tu = (PL.query_threshold_union_packed,
              (eng.table, eng.bits, codes2, bad),
              dict(common, num_colors=C, color_runs=cr))
    km = (PL.query_kmer_matches_packed2, (eng.table, eng.bits, codes2, bad),
          dict(common, num_colors=C, color_runs=cr))
    return {"FI": fi, "TU": tu, "km": km}


def memory_report(label: str, fn, args, kw, lanes: int):
    t0 = time.perf_counter()
    ma = fn.lower(*args, **kw).compile().memory_analysis()
    dt = time.perf_counter() - t0
    per_lane = (ma.temp_size_in_bytes + ma.output_size_in_bytes) / lanes
    log(f"memory_analysis {label}: temp {ma.temp_size_in_bytes} "
        f"output {ma.output_size_in_bytes} argument "
        f"{ma.argument_size_in_bytes} generated_code "
        f"{ma.generated_code_size_in_bytes} bytes; "
        f"{per_lane:.0f} B/lane over {lanes} lanes; compile {dt:.1f} s")
    return ma, per_lane


def compile_phase(eng, name: str) -> float:
    """memory_analysis of the corpus' FI/TU/km graphs at the bench shape
    and at the widest ladder rung; -> the largest B/lane seen."""
    worst = 0.0
    for W in (BENCH_W, E.MAX_STREAM_WIDTH):
        B = BATCH if W == BENCH_W else eng._batch_for_width(W)
        lanes = B * (W - eng.k + 1)
        for tool, (fn, args, kw) in step_graphs(eng, B, W).items():
            _, pl = memory_report(f"{name} {tool} B={B} W={W}", fn, args, kw,
                                  lanes)
            worst = max(worst, pl)
    if name == "clonal10":
        onehot_phase(eng)
    return worst


def onehot_phase(eng, S: int = ONEHOT_MAX_SETS, B: int = BATCH,
                 W: int = BENCH_W):
    """The one-hot FI graph at S sets must fuse its (B, Wk, S+1) compare
    into the reduction. Its memory beyond the same graph at 2 sets (probe
    and outputs are alike) must stay below one byte per compare element;
    unfused, the f32 compare alone takes four."""
    Wk = W - eng.k + 1
    codes2 = jax.ShapeDtypeStruct((B, W // 4), np.uint8)
    bad = jax.ShapeDtypeStruct((B, W // 8), np.uint8)
    temp = {}
    for s in (2, S):
        bits = jax.ShapeDtypeStruct((s, eng.idx.words_per_set), np.uint32)
        ma, _ = memory_report(
            f"one-hot FI S={s} B={B} W={W}",
            PL.query_full_intersection_packed, (eng.table, bits, codes2, bad),
            dict(k=eng.k, width=W, dparams=eng.dparams,
                 color_runs=eng._color_runs(W), probe_budget=eng._pb),
            B * Wk)
        temp[s] = ma.temp_size_in_bytes
    extra, unfused = temp[S] - temp[2], B * Wk * (S + 1)
    if extra >= unfused:
        raise SystemExit(f"one-hot compare not fused: S={S} takes {extra} "
                         f"more temp bytes than S=2 (>= {unfused})")
    log(f"one-hot compare fused: S={S} takes {extra} more temp bytes than "
        f"S=2, < {unfused} (one byte per compare element)")


# ------------------------------------------------------------------ drivers

def prepare_corpus(name: str, work: str):
    """Generate, build and simulate reads for one corpus; -> (index,
    reads path, reads)."""
    t0 = time.perf_counter()
    paths = corpus_genomes(name, os.path.join(work, name))
    t_sim = time.perf_counter() - t0
    index, t_build = build_index_cli(paths, os.path.join(work, name))
    idx = Index.load(index)
    nu = len(idx.unitig_offs) - 1
    log(f"corpus {name}: {len(paths)} genomes generated in {t_sim:.1f} s, "
        f"built in {t_build:.1f} s: {idx.num_kmers} kmers, "
        f"{idx.num_colors} colors, {idx.num_color_sets} sets, "
        f"{nu} unitigs, words_per_set {idx.words_per_set}")
    stride, seed = READ_SOURCE[name]
    reads_path = os.path.join(work, f"{name}.fq")
    reads = write_reads(paths[::stride], NUM_READS, seed, reads_path)
    return index, reads_path, reads


def one_gpu(work: str) -> None:
    dev = device_phase(1)
    t0 = time.perf_counter()
    native._load()
    log(f"native library ready in {time.perf_counter() - t0:.1f} s")
    log(f"reduced: pansal4546 genes per genome / {PANSAL_GENE_CUT} "
        f"({json.dumps(pansal_cut(PANSAL_GENE_CUT))}); the full corpus "
        f"builds for ~30 min, past this script's 1200 s limit")
    eng_lanes = E.max_lanes(E.device_bytes_limit())
    log(f"lane budget: {eng_lanes} lanes ({E.LANE_BYTES} B/lane, "
        f"{E.LANE_MEM_FRACTION} of bytes_limit); batch at W={BENCH_W}: "
        f"{E.batch_for_width(BATCH, BENCH_W, K, eng_lanes)}, at "
        f"W={E.MAX_STREAM_WIDTH}: "
        f"{E.batch_for_width(BATCH, E.MAX_STREAM_WIDTH, K, eng_lanes)}")
    if E.batch_for_width(BATCH, BENCH_W, K, eng_lanes) != BATCH:
        raise SystemExit("the 150 bp batch shrank below 32768")
    worst = 0.0
    for name in CORPORA:
        index, reads_path, reads = prepare_corpus(name, work)
        eng = E.QueryEngine(Index.load(index), batch_size=BATCH)
        query_phase(eng, name, index, reads_path, reads, NUM_READS, work)
        worst = max(worst, compile_phase(eng, name))
        del eng
        shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    log(f"largest per-lane footprint: {worst:.0f} B/lane "
        f"(LANE_BYTES = {E.LANE_BYTES})")
    finish(dev, len(jax.devices()))


def sorted_lines(path: str) -> list[bytes]:
    with open(path, "rb") as f:
        return sorted(f)


def four_gpus(work: str) -> None:
    """FI, TU, kc and km on pan1k through the default engine (a mesh over
    the four cards), compared with the same engine on one card."""
    dev = device_phase(4)
    index, reads_path, reads = prepare_corpus("pan1k", work)
    idx = Index.load(index)
    meshed = E.QueryEngine(idx)
    if meshed.mesh is None:
        raise SystemExit("the default engine built no mesh on 4 devices")
    single = E.QueryEngine(idx, use_mesh=False)
    log(f"mesh: {dict(meshed.mesh.shape)}; single-card flags: "
        f"{json.dumps(engine_flags(single))}")
    for tool, method, kw in (
            ("FI", "pseudoalign_file", {}),
            ("TU(0.8)", "pseudoalign_file", {"threshold": 0.8}),
            ("kc", "kmer_conservation_file", {}),
            ("km", "kmer_matches_file", {})):
        outs = {}
        for label, eng in (("mesh", meshed), ("single", single)):
            out = os.path.join(work, f"four.{label}")
            t0 = time.perf_counter()
            getattr(eng, method)(reads_path, out, **kw)
            dt = time.perf_counter() - t0
            outs[label] = sorted_lines(out)
            log(f"four {tool} {label}: {len(outs[label])} lines in "
                f"{dt:.1f} s incl. compile")
            os.remove(out)
        if outs["mesh"] != outs["single"]:
            diff = sum(a != b for a, b in zip(outs["mesh"], outs["single"]))
            raise SystemExit(f"four {tool}: sharded output differs from one "
                             f"card ({diff} sorted lines differ)")
        log(f"four {tool}: sharded output equals one card "
            f"({len(outs['mesh'])} sorted lines)")
    finish(dev, len(jax.devices()))


def finish(dev, count: int) -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh path on four GPUs")
    args = ap.parse_args(argv)
    enable_compile_cache()
    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        (four_gpus if args.four else one_gpu)(WORK)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)


if __name__ == "__main__":
    main()
