"""Multi-host scale-out for the query tools.

The reference is a single-process, multi-threaded program (worker threads
over reads, src/psa.cpp); scaling past one host is this framework's
extension target (SURVEY §2.3, BASELINE.md "1→N host scaling"). The
design keeps the network between machines off the hot path entirely:

  * reads are DATA-parallel across host processes — each process queries
    only chunks with index % num_procs == proc_id of the shared FASTQ
    (engine._stream(shard=...)), using its LOCAL device mesh
    (parallel/mesh.py) for the color-TP/ reads-DP work over the
    machine's own device interconnect (NVLink between GPUs);
  * read ids stay GLOBAL file ordinals, so per-process fragments k-way
    merge by id into the byte-equal single-host output;
  * the only cross-host traffic is jax.distributed bring-up, one barrier
    when fragments are complete, and the filesystem merge on process 0 —
    dense compute + collectives within one machine, embarrassingly-
    parallel sharding across machines.

Every process parses the whole (usually gzip) stream but DISPATCHES only
its own chunks: sequential decompress+parse runs at native speed on the
prefetch thread (~3% of single-host wall time) and cannot be seeked in
.gz inputs; skipping others' chunks still skips all device work, host
reduction, and formatting, which is where the time goes.
"""

from __future__ import annotations

import heapq
import os

import numpy as np


# --------------------------------------------------------------- bring-up


def init_multihost(coordinator: str | None = None,
                   num_procs: int | None = None,
                   proc_id: int | None = None):
    """Initialize jax.distributed from args or environment.

    Env: FULGOR_COORDINATOR (host:port), FULGOR_NUM_PROCS, FULGOR_PROC_ID.
    Returns (proc_id, num_procs). With num_procs == 1 (or nothing
    configured) this is a no-op single-process setup — the query tools
    then behave exactly as without multihost."""
    import jax

    coordinator = coordinator or os.environ.get("FULGOR_COORDINATOR")
    if num_procs is None:
        num_procs = int(os.environ.get("FULGOR_NUM_PROCS", "1"))
    if proc_id is None:
        proc_id = int(os.environ.get("FULGOR_PROC_ID", "0"))
    if num_procs <= 1:
        return 0, 1
    if not coordinator:
        raise ValueError("multihost needs a coordinator address "
                         "(FULGOR_COORDINATOR=host:port)")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_procs,
        process_id=proc_id,
    )
    return proc_id, num_procs


def barrier(name: str = "fulgor"):
    """Global cross-process barrier (no-op single-process)."""
    import jax

    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


# ----------------------------------------------------------------- merge


# Every fragment stream below is id-ASCENDING by construction: sharded
# pseudoalign_file writes batches in file order and diverts deferred-redo
# stragglers to a `.redo` side fragment (engine.pseudoalign_file
# straggler sink), whose flushes are also ascending. The merge is thus a
# pure k-way heap merge over sequential readers — memory is O(num
# fragments), never O(file) (round-3/4 versions buffered whole fragments,
# which does not scale to the baseline's 6.58M reads x 4,546 colors).


def _checked_ascending(it, path: str):
    last = -1
    for qid, payload in it:
        if qid < last:
            raise ValueError(
                f"{path}: fragment records not id-ascending ({qid} after "
                f"{last}); was it written by a pre-streaming-merge build?")
        last = qid
        yield qid, payload


def _iter_ascii_records(path: str):
    """Yield (qid, line_bytes) from an ascii psa fragment, sequentially."""
    with open(path, "rb") as f:
        for ln in f:
            if ln.strip():
                yield int(ln.split(b"\t", 1)[0]), ln


def merge_psa_ascii(parts: list[str], out_path: str):
    streams = [_checked_ascending(_iter_ascii_records(p), p) for p in parts]
    with open(out_path, "wb", buffering=1 << 20) as f:
        for _qid, line in heapq.merge(*streams, key=lambda r: r[0]):
            f.write(line)


def _iter_binary_records(path: str):
    """Yield (qid, record_bytes) from a binary psa fragment (u32 qid,
    u32 n, u32 colors[n] little-endian), sequentially."""
    with open(path, "rb", buffering=1 << 20) as f:
        while True:
            head = f.read(8)
            if not head:
                return
            assert len(head) == 8, f"{path}: truncated record header"
            qid, n = np.frombuffer(head, dtype=np.uint32)
            body = f.read(4 * int(n))
            assert len(body) == 4 * int(n), f"{path}: truncated record body"
            yield int(qid), head + body


def merge_psa_binary(parts: list[str], out_path: str):
    streams = [_checked_ascending(_iter_binary_records(p), p) for p in parts]
    with open(out_path, "wb", buffering=1 << 20) as f:
        for _qid, rec in heapq.merge(*streams, key=lambda r: r[0]):
            f.write(rec)


def merge_psa_compressed(parts: list[str], out_path: str):
    """Stream-decode fragments frame-at-a-time, re-encode id-ordered. The
    compressed stream groups records into flush frames
    (query/formatters.py), so a merged file must re-frame; output is a
    valid CompressedFormatter file with identical decoded content."""
    from ..query.formatters import (CompressedFormatter,
                                    compressed_psa_num_colors,
                                    iter_compressed_psa)

    ncs = [compressed_psa_num_colors(p) for p in parts]
    num_colors = ncs[0] if ncs else 0
    assert all(nc == num_colors for nc in ncs), "fragment num_colors mismatch"
    streams = [
        _checked_ascending(iter_compressed_psa(p, num_colors), p)
        for p in parts
    ]
    fmtr = CompressedFormatter(out_path, int(num_colors))
    STEP = 1 << 15
    qids, lists = [], []
    for qid, cols in heapq.merge(*streams, key=lambda r: r[0]):
        qids.append(qid)
        lists.append(cols)
        if len(qids) >= STEP:
            fmtr.write_batch(qids, lists)
            qids, lists = [], []
    if qids:
        fmtr.write_batch(qids, lists)
    fmtr.close()


_MERGERS = {
    "ascii": merge_psa_ascii,
    "binary": merge_psa_binary,
    "compressed": merge_psa_compressed,
}


def merge_fragments(parts: list[str], out_path: str, fmt: str) -> list[str]:
    """Merge main fragments plus their `.redo` straggler side fragments
    (deferred-redo output under sharding) into out_path; returns the list
    of fragment files actually consumed (for cleanup)."""
    full = []
    for p in parts:
        full.append(p)
        if os.path.exists(p + ".redo"):
            full.append(p + ".redo")
    full = [p for p in full if os.path.exists(p)]
    _MERGERS[fmt](full, out_path)
    return full


# ---------------------------------------------------------------- driver


def pseudoalign_multihost(
    engine,
    query_path: str,
    out_path: str,
    threshold=None,
    fmt: str = "ascii",
    verbose: bool = False,
    proc_id: int | None = None,
    num_procs: int | None = None,
):
    """Run pseudoalign sharded over already-initialized processes.

    Each process writes `{out_path}.part{pid}`; after a global barrier,
    process 0 merges fragments by read id into `out_path` and removes
    them. Single-process (num_procs in {None from env, 1}) degenerates
    to engine.pseudoalign_file. Returns this process's stats dict (with
    num_reads = reads THIS process mapped, num_reads_total = whole
    file)."""
    import jax

    if num_procs is None:
        num_procs = jax.process_count()
    if proc_id is None:
        proc_id = jax.process_index()
    if num_procs <= 1:
        return engine.pseudoalign_file(query_path, out_path,
                                       threshold=threshold, fmt=fmt,
                                       verbose=verbose)
    part = f"{out_path}.part{proc_id}"
    stats = engine.pseudoalign_file(query_path, part, threshold=threshold,
                                    fmt=fmt, verbose=verbose,
                                    shard=(proc_id, num_procs))
    barrier("psa-fragments")
    if proc_id == 0:
        used = merge_fragments(
            [f"{out_path}.part{p}" for p in range(num_procs)], out_path, fmt)
        for p in used:
            os.remove(p)
    barrier("psa-merged")
    return stats
