"""Host query orchestration (reference L7/L8: tools/pseudoalign.cpp et al.).

The reference's thread-pool-of-readers becomes a streaming pipeline:

    native chunked FASTA/FASTQ parse  ->  fixed-shape device batches
    (ReadsStream, overlaps device)        (async jit dispatch, <=2 in flight)
    ->  host fetch + native formatting (runs while the device computes the
        next chunks)

Batch widths come from a small ladder so jit compiles stay bounded.

Output is strictly in READ-ID ORDER: reads the device path cannot decide
exactly (probe/run-budget overflow, or longer than the widest ladder rung)
are redone INLINE while their batch is being consumed — small-bucket device
re-probe first, exact host mirror for the rest — and their results merged
back into the batch at their positions. This is what makes the single-device,
mesh, and multi-host engines byte-identical for the same input (the
reference's own thread-pool order is nondeterministic, README.md:220; ours
is stronger so equality is testable). The host mirrors (_host_*) also serve
tooling and tests.
"""

from __future__ import annotations

import time
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import INVALID_U32
from ..index import Index
from ..ops.lookup import pack_reads_host
from ..ops.pipeline import (
    color_runs_budget,
    query_conservation_runs_packed,
    query_distinct_runs_packed,
    query_runs_tu_packed,
    query_fi_lists_packed,
    query_full_intersection,
    query_full_intersection_packed,
    query_kmer_matches_packed2,
    query_threshold_union,
    query_threshold_union_packed,
    query_tu_lists_packed,
    query_window_csids,
)
from .formatters import make_formatter


class AsyncWriter:
    """Runs formatter writes on a worker thread so ascii formatting + file
    IO (ctypes releases the GIL during the native calls) overlap device
    compute and the next batch's result fetch. FIFO queue preserves output
    order; `mapped` and `busy_sec` are valid after close()."""

    def __init__(self, fmtr):
        import queue
        import threading

        self.fmtr = fmtr
        self.q = queue.Queue(maxsize=4)
        self.mapped = 0
        self.busy_sec = 0.0
        self.err = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            try:
                t0 = time.perf_counter()
                kind, a, b, c = item
                if kind == "bits":
                    self.mapped += self.fmtr.write_batch_bits(a, b)
                elif kind == "grouped":
                    self.mapped += self.fmtr.write_batch_bits_grouped(a, b, c)
                else:
                    self.fmtr.write_batch(a, b)
                    self.mapped += sum(1 for s in b if len(s))
                self.busy_sec += time.perf_counter() - t0
            except BaseException as e:  # surfaced on next write or close
                self.err = e

    def _put(self, item):
        if self.err is not None:
            raise self.err
        self.q.put(item)

    def write_batch_bits(self, ids, rows):
        self._put(("bits", ids, rows, None))

    def write_batch_bits_grouped(self, ids, rows, inv):
        self._put(("grouped", ids, rows, inv))

    def write_batch(self, ids, lists):
        self._put(("lists", list(ids), list(lists), None))

    def close(self):
        self.q.put(None)
        self.t.join()
        if self.err is not None:
            raise self.err
        self.fmtr.close()


WIDTH_LADDER = (64, 96, 128, 160, 192, 256, 384, 512, 768, 1024)
MAX_STREAM_WIDTH = WIDTH_LADDER[-1]


def _prefetch(handle, skip=()):
    """Start async device->host copies for a dispatch result's (small)
    outputs so the transfer overlaps the current batch's host stage instead
    of serializing into every np.asarray at consume time. skip: indices to
    keep device-resident (e.g. the full per-window csid array)."""
    for i, a in enumerate(handle):
        if i not in skip:
            try:
                a.copy_to_host_async()
            except AttributeError:
                pass
    return handle

import os as _os

# Device-side result compaction kicks in when the dense (B, C32) result
# fetch would dominate the device->host link: ship <=T_LIST color ids per
# read + selective row fetches for the rare larger results.
LISTS_MIN_WORDS = 64
T_LIST = 64
# TU device-thresholding (fetch the passing-color bitmap instead of (C,)
# u16 scores) kicks in at >=8 words (>256 colors).
TU_BITS_MIN_WORDS = 8
# Runs-compacted FI fetch (distinct csids per read + host dedup-intersect)
# kicks in only past LISTS_MIN_WORDS colors: adjacent-run compaction keeps
# ~2x the unitig crossings per read, so the budget must be generous
# (RUNS_FI_BUDGET) — below ~2048 colors the dense row is already smaller.
# Both knobs are env-overridable for on-hardware A/B tuning.
RUNS_FI_BUDGET = int(_os.environ.get("FULGOR_RUNS_FI_BUDGET", "48"))
RUNS_MIN_WORDS = int(_os.environ.get("FULGOR_RUNS_MIN_WORDS", str(LISTS_MIN_WORDS)))
# Probe-lane budget per device dispatch: B_eff * (W - k + 1) <= max_lanes.
# A query graph's device memory (temporaries + outputs) scales with its
# lane count. compiled.memory_analysis() of the FI, TU and kmer-matches
# graphs on an NVIDIA H100 80GB HBM3 (chip_smoke.py's compile report, three
# corpora, W=160 and W=1024) gave 167-255 B/lane; LANE_BYTES rounds the
# largest up. The lanes of one dispatch may take LANE_MEM_FRACTION of the
# device's memory, leaving the rest to the index and the results in
# flight. Wide ladder rungs therefore dispatch in smaller sub-batches
# instead of shrinking the whole stream's batch.
LANE_BYTES = 256
LANE_MEM_FRACTION = 0.5


def max_lanes(bytes_limit: int) -> int:
    """Probe lanes one dispatch may hold on a device of bytes_limit."""
    return int(bytes_limit * LANE_MEM_FRACTION) // LANE_BYTES


def device_bytes_limit() -> int:
    """Memory JAX may allocate on the first local device. The CPU backend
    reports no memory stats; its device memory is the host's RAM."""
    stats = jax.local_devices()[0].memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return _os.sysconf("SC_PAGE_SIZE") * _os.sysconf("SC_PHYS_PAGES")


def batch_for_width(batch: int, W: int, k: int, lanes: int) -> int:
    """Largest dispatch batch <= batch whose probe-lane count B*(W-k+1)
    fits `lanes`. Rounded down to a multiple of 256 so a sub-batch splits
    evenly over the devices of a mesh and each ladder width compiles one
    batch shape."""
    Wk = max(1, W - k + 1)
    return max(256, min(batch, (lanes // Wk) & ~255))


def _runs_budget(W: int, ekpu: float = 64.0, k: int = 31) -> int:
    """kmer-conservation run budget per read width (runs beyond it -> exact
    redo). Locality-aware: on clonal indexes a 150 bp read rarely crosses
    >4 unitig/color boundaries, but shredded graphs split a conservation
    run at EVERY csid change and hit/miss boundary — pan1k measured 81%
    of reads past even R=48 — so low-locality indexes (read-weighted
    kmers-per-unitig under 32) fetch one record per WINDOW: exact, no
    overflow, and at 12 B/record the full-width fetch is ~50 MB per 32k
    batch (cheap next to the probe)."""
    if ekpu < 32.0:
        return max(1, W - k + 1)
    return 16 if W <= 256 else max(16, W // 16)


def _round_up(x, m):
    return -(-x // m) * m


def bucket_widths(lens: np.ndarray, k: int, max_buckets: int = 4):
    """Choose up to max_buckets padded widths (multiples of 32, >= k+31)."""
    if len(lens) == 0:
        return [k + 31]
    qs = np.quantile(lens, np.linspace(0, 1, max_buckets + 1)[1:], method="higher")
    widths = sorted({max(_round_up(int(q), 32), _round_up(k + 1, 32)) for q in qs})
    return widths


class QueryEngine:
    """use_mesh: None = auto (mesh when >1 device), True/False to force.
    With a mesh, reads are data-parallel and the color-bit words are
    tensor-parallel across all devices (parallel/mesh.py)."""

    def __init__(self, index: Index, batch_size: int = 32768, use_mesh=None):
        self.idx = index
        self.k = index.k
        self._cs_cache = index.color_sets_decoded()
        # color-stage strategy input: read-weighted streaming locality
        self._ekpu = index.expected_kmers_per_unitig()
        runs_ok = self._ekpu >= 8.0
        table_np, self.dparams = index.device_dict()
        # LOCAL devices only: under jax.distributed (parallel/multihost.py)
        # reads are data-parallel across processes and each process meshes
        # its own machine's devices — never a mesh that spans machines
        n_dev = len(jax.local_devices())
        self.max_lanes = max_lanes(device_bytes_limit())
        self.mesh = None
        # dense-bits feasibility: the (S, C32) matrix must fit host+device
        # comfortably; past this the engine runs the no-dense-matrix paths
        # (on-demand row decode). Env-tunable for A/B.
        dense_bytes = index.num_color_sets * index.words_per_set * 4
        dense_ok = dense_bytes <= int(
            _os.environ.get("FULGOR_DENSE_MAX_BYTES", str(3 << 30)))
        large_c = index.words_per_set > RUNS_MIN_WORDS
        if use_mesh or (use_mesh is None and n_dev > 1):
            from ..parallel import mesh as M

            from jax.sharding import NamedSharding, PartitionSpec as P

            self.mesh = M.make_mesh()
            shards = self.mesh.shape["color"]
            rep = NamedSharding(self.mesh, P())
            self.table = jax.tree.map(lambda a: jax.device_put(a, rep), table_np)
            # bits upload is LAZY under the mesh too: the runs-fetch FI/TU
            # paths never touch it, so the 150k-color regime materializes
            # no dense matrix on host OR devices (the mesh must compose
            # with large C)
            self._bits = None
            self._mesh_mod = M
            n_cells = self.mesh.shape["data"] * shards
            batch_size = _round_up(batch_size, n_cells)
        else:
            self.table = jax.tree.map(jnp.asarray, table_np)
            # device bits upload is LAZY: the runs-fetch FI path never
            # touches it, so at very large C (150k-color regime) neither
            # the host dense matrix nor its device copy materializes
            self._bits = None
        self.batch = batch_size
        self._mesh_fns = {}
        # list-compacted fetches (single-device path): worth it once the
        # dense row fetch is wide; below that the dense fetch is small and
        # the extra kernel work is pure overhead
        # device-side list compaction: the default large-C FI fetch when
        # runs don't compact (also a manual-override/tuning knob)
        self.use_lists = large_c and not runs_ok and dense_ok
        # runs-compacted FI fetch + exact host dedup-intersect: past ~2048
        # colors the dense (B, C32) row fetch grows with C, while
        # <=RUNS_FI_BUDGET run csids per read cost a fixed 192 B
        # and the distinct-list intersections are trivial host AND-reductions
        # (the reference's --deduplicate flow, made the default fetch).
        # TU always gets the device-thresholded bitmap fetch past 256 colors.
        # large C + streaming locality: runs fetch (works under mesh too —
        # the probe is data-parallel and ships only run csids, no dense
        # matrix anywhere). On SNP-shredded graphs runs don't compact, so
        # large-C FI uses device LIST compaction instead (T_LIST ids/read
        # + selective row fetches).
        self.use_runs_fetch = large_c and (runs_ok or not dense_ok)
        self._runs_ok = runs_ok
        # adaptive runs-fetch budget: starts at RUNS_FI_BUDGET; if a batch
        # shows >2% of reads past it (heavy distinct-run tails — pansal4546
        # sits at p90=50/p99=63 vs the default 48), later dispatches double
        # it (one extra jit variant; the fetch bytes are prefetched and
        # overlap the host stage, so the larger R is nearly free while the
        # per-batch overflow recovery is not)
        self._runs_R = RUNS_FI_BUDGET
        self._cr_off = False  # see _color_runs
        if self.use_runs_fetch and dense_ok:
            # the runs-path host stage reads color rows per distinct key;
            # when the dense matrix FITS, materialize it up front so
            # color_rows is one fancy-index instead of the memo-dict decode
            # (profiled on pansal4546: 17 s of a 44 s host stage was the
            # memo fan-out loop)
            self.idx.dense_color_bits()
        self.use_tu_bits = (
            self.mesh is None
            and dense_ok
            and index.words_per_set >= TU_BITS_MIN_WORDS
        )
        # TU past dense feasibility scores on host from (csid, count) runs
        # against on-demand decoded sets (no dense matrix anywhere)
        self.use_tu_runs = not dense_ok
        self._ms_tabs: dict = {}
        # cross-batch FI result cache for the runs path: distinct-csid key
        # bytes -> intersected (C32,) row. Clonal corpora repeat a small
        # set of hot keys across every batch (reads inside one core-gene
        # region all share a key), so later batches skip the row gather +
        # AND-reduce entirely. Bounded; cleared when full.
        self._fi_key_cache: dict = {}
        # cap by BYTES, not entries: each value is a (words_per_set,) u32
        # row plus a key of similar order, so at 150k colors (~4.7k words)
        # an entry-count cap would let the cache grow to GiBs exactly in
        # the memory-tight no-dense-matrix regime. Entry cap derived from
        # the byte budget; FULGOR_FI_KEY_CACHE (entries) still wins if set.
        _cache_bytes = int(
            _os.environ.get("FULGOR_FI_KEY_CACHE_BYTES", str(256 << 20)))
        _per_entry = max(64, 8 * index.words_per_set)  # value + typical key
        self._fi_key_cache_cap = int(
            _os.environ.get("FULGOR_FI_KEY_CACHE",
                            str(max(1024, _cache_bytes // _per_entry))))
        # probe budgets (VERIFY_BUDGET, SKEW_CAND): the MAIN kernels run
        # trimmed budgets when the dictionary is skew-LIGHT — every verify
        # and skew candidate adds gathers over the whole lane grid
        # (DESIGN-NOTES §18) — and the few ovf reads re-derive through the
        # full-budget REDO kernel (_device_csids_many), which is exact. On
        # skew-HEAVY dictionaries (shredded graphs breed heavy minimizer
        # groups: pan1k routes most hits via the skew table) trimmed
        # budgets overflow whole percents of reads, so full budgets stay. The
        # covered-entry fraction of the slot array is the signal
        # (salmonella 0.05, pansal4546 ~0.3, pan1k 0.52). Env-tunable.
        pb_env = _os.environ.get("FULGOR_PROBE_BUDGET")
        if pb_env:
            self._pb = tuple(int(x) for x in pb_env.split(","))
        elif self.dparams is None:
            self._pb = None  # cuckoo backend: no budgets
        else:
            ms = index.mini_slots[:, 2::3]
            covb = ((ms >> np.uint32(15)) & np.uint32(1)) == 1
            occ = int(((((ms >> np.uint32(8)) & np.uint32(0x7F)) > 0)
                       | covb).sum())
            covn = int(covb.sum())
            self._covered_frac = covn / max(1, occ)
            # One-pass probe budgets by skew band. The STAGED probe
            # (FULGOR_PROBE_BUDGET=vb1,vb2,sc,RU — 2 verifies on every
            # lane, full budget + skew only on per-read compacted
            # undecided lanes) stays OPT-IN ONLY: both its tiers flood on
            # real inputs. Read-weighted skew need far exceeds occupancy
            # covered_frac (pansal4546: occupancy 0.26 but 48% of windows
            # need the skew table -> 88% of reads past RU=16), and read
            # ERRORS undecide ~2(k-m) windows each, so at 0.5%/bp the 53%
            # of reads with >=1 error are all "heavy" even on skew-light
            # salmonella (16% of reads redone). Bands:
            #  <0.10 skew-light (salmonella): trimmed, the round-3 winner;
            #        the rare overflow reads take the host mirror.
            #  0.10-0.45 mid (pansal4546 runs-fetch regime): the host is
            #        the wall and the device has slack — the full budget
            #        cuts probe-overflow reads ~6x vs the mid trim.
            #  >=0.45 skew-heavy (pan1k shredded graphs): device-bound,
            #        mid budgets balance probe cost vs overflow rate.
            # Verify budgets are HALF the round-3 bands: the strand-bit
            # entry layout spawns one oriented candidate per slot entry
            # instead of two, so candidate pressure halved (skew budgets
            # stay — pointer counts are strand-independent).
            self._pb = ((2, 2) if self._covered_frac < 0.10
                        else (4, 4) if self._covered_frac < 0.45
                        else (3, 3))
        self._pb_redo = tuple(int(x) for x in _os.environ.get(
            "FULGOR_PROBE_BUDGET_REDO", "8,4").split(","))
        # FULGOR_SELFCHECK=N: runtime oracle (the reference's Debug-build
        # asserts, include/util.hpp:106-208) — every batch, reads whose
        # global id is divisible by N recompute through the exact host
        # mirror and must match the device result byte-for-byte. N=1 checks
        # every read; 0/unset disables. num_selfchecked counts the reads
        # compared so far.
        self._selfcheck = int(_os.environ.get("FULGOR_SELFCHECK", "0"))
        self.num_selfchecked = 0

    @property
    def bits(self):
        if self._bits is None:
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                b = self._mesh_mod.pad_bits_for_mesh(
                    self.idx.dense_color_bits(), self.mesh.shape["color"])
                self._bits = jax.device_put(
                    b, NamedSharding(self.mesh, P(None, "color")))
            else:
                self._bits = jnp.asarray(self.idx.dense_color_bits())
        return self._bits

    def _minscore_tab(self, threshold: float, W: int):
        """floor(npos * tau) for npos in [0, W] (f64 on host; exact device
        thresholding via a gather — see query_tu_lists_packed)."""
        key = (threshold, W)
        if key not in self._ms_tabs:
            npos = np.arange(W + 1, dtype=np.float64)
            self._ms_tabs[key] = jnp.asarray(
                (npos * threshold).astype(np.int64).astype(np.int32)
            )
        return self._ms_tabs[key]

    def _fetch_rows(self, arr, idx: np.ndarray) -> np.ndarray:
        """Fetch selected rows of a device (B, C32) array (pow2-bucketed
        gather so recompiles stay bounded)."""
        if len(idx) == 0:
            return np.zeros((0, arr.shape[1]), np.uint32)
        nb = 1 << (len(idx) - 1).bit_length()
        pad = np.zeros(nb, np.int32)
        pad[: len(idx)] = idx
        return np.asarray(jnp.take(arr, jnp.asarray(pad), axis=0))[: len(idx)]

    # ---------------------------------------------------------------- helpers

    def _color_runs(self, W: int):
        """Static color-stage run budget for width W (None = per-window).
        _cr_off: measured de-escalation — when a batch's overflow shows the
        run budget not compacting on this corpus, later dispatches take
        the per-window variant instead of flooding the deferred redo."""
        if self._cr_off:
            return None
        return color_runs_budget(W - self.k + 1, self._ekpu)

    def _width_for(self, maxlen: int) -> int:
        need = max(int(maxlen), self.k + 1)
        for w in WIDTH_LADDER:
            if w >= need:
                return w
        return MAX_STREAM_WIDTH

    def _batch_for_width(self, W: int) -> int:
        """Dispatch batch for ladder width W (see batch_for_width)."""
        return batch_for_width(self.batch, W, self.k, self.max_lanes)

    def _iter_batches(self, codes: np.ndarray, lens: np.ndarray):
        """Array-API batching (library/tests): yield (read_indices, padded
        (B, W) uint8 batch), bucketing reads by length."""
        widths = bucket_widths(lens, self.k)
        assign = np.searchsorted(widths, np.maximum(lens, self.k), side="left")
        assign = np.minimum(assign, len(widths) - 1)
        for wi, Wd in enumerate(widths):
            ridx = np.flatnonzero(assign == wi)
            B_eff = self._batch_for_width(Wd)  # lane budget, see LANE_BYTES
            for lo in range(0, len(ridx), B_eff):
                sel = ridx[lo : lo + B_eff]
                chunk = np.full((B_eff, Wd), 4, dtype=np.uint8)
                take = codes[sel]
                cols = min(Wd, take.shape[1])
                chunk[: len(sel), :cols] = take[:, :cols]
                yield sel, chunk

    def _host_csids(self, row_codes: np.ndarray):
        """Exact host window->csid for one read (slow path)."""
        _hit, csid = self.idx.host_window_csids(row_codes.astype(np.uint8))
        return csid

    def _host_csids_many(self, rows) -> list:
        """Exact host window->csid for MANY ragged reads in one vectorized
        probe: reads are joined with a single invalid code (4) so every
        boundary-crossing window self-invalidates, then sliced back per
        read. Orders of magnitude faster than per-read probes when the
        overflow-redo batch has hundreds of reads."""
        if not len(rows):
            return []
        k = self.k
        parts, starts, pos = [], [], 0
        sep = np.full(1, 4, dtype=np.uint8)
        for r in rows:
            starts.append(pos)
            parts.append(np.asarray(r, dtype=np.uint8))
            parts.append(sep)
            pos += len(r) + 1
        csid = self._host_csids(np.concatenate(parts))
        out = []
        for r, s in zip(rows, starts):
            n = max(0, len(r) - k + 1)
            out.append(csid[s : s + n])
        return out

    def _device_csids_dispatch(self, rows) -> list:
        """Dispatch the DEVICE per-window probe for many ragged reads and
        return an opaque state of in-flight result handles — resolution
        (and the device round-trip wait) happens in _device_csids_resolve,
        so the caller can overlap the programs with other work (the
        deferred-redo flush resolves one flush-interval later)."""
        from ..ops.pipeline import query_window_csids_packed

        state = []
        fit = [i for i, r in enumerate(rows) if len(r) <= MAX_STREAM_WIDTH]
        # pow2 dispatch buckets: bucket sizes are determined by the
        # (deterministic) overflow counts, so compile variants stay few and
        # the bench warm-up run compiles them all.
        B = min(self.batch, max(256, 1 << (max(1, len(fit)) - 1).bit_length()))
        for i0 in range(0, len(fit), B):
            sel = fit[i0: i0 + B]
            maxl = max(len(rows[i]) for i in sel)
            W = self._width_for(maxl)
            chunk = np.full((B, W), 4, dtype=np.uint8)
            for j, i in enumerate(sel):
                chunk[j, : len(rows[i])] = rows[i]
            codes2, bad = pack_reads_host(chunk)
            out = query_window_csids_packed(
                self.table, codes2, bad, k=self.k, width=W,
                dparams=self.dparams, probe_budget=self._pb_redo)
            state.append((sel, _prefetch(out)))
        return state

    def _device_csids_resolve(self, rows, state) -> list:
        """Collect a _device_csids_dispatch state. Entries come back None
        for reads the device CANNOT decide exactly: probe-lane overflow
        (needs the host-exact probe) or length past the stream ladder."""
        out: list = [None] * len(rows)
        k = self.k
        for sel, handle in state:
            hit = np.asarray(handle[0][: len(sel)])
            csid = np.asarray(handle[1][: len(sel)])
            ovf = np.asarray(handle[2][: len(sel)])
            vals = np.where(hit, csid, np.uint32(INVALID_U32))
            for j, i in enumerate(sel):
                if ovf[j].any():
                    continue  # probe-lane overflow: host-exact only
                n = max(0, len(rows[i]) - k + 1)
                out[i] = vals[j, :n]
        return out

    def _device_csids_many(self, rows) -> list:
        """Exact per-window csids for many ragged reads via the DEVICE
        per-window probe (synchronous dispatch + resolve). The color-stage
        run-budget overflow redo needs only window csids — which the
        per-window kernel produces at device speed — so those reads never
        pay the exact-host probe (~4 ms/read; the reference's equivalent of
        this fallback is simply its normal per-k-mer path,
        src/ps_full_intersection.cpp:341-353)."""
        return self._device_csids_resolve(rows, self._device_csids_dispatch(rows))

    def _fi_from_csids(self, csids: np.ndarray) -> np.ndarray:
        cat, offs = self._cs_cache
        distinct = np.unique(csids[csids != INVALID_U32])
        if len(distinct) == 0:
            return np.empty(0, dtype=np.uint32)
        acc = None
        for sid in distinct:
            s = cat[offs[sid] : offs[sid + 1]]
            acc = s if acc is None else np.intersect1d(acc, s, assume_unique=True)
            if len(acc) == 0:
                break
        return acc.astype(np.uint32)

    def _intersect_segments(self, flat: np.ndarray,
                            sizes: np.ndarray) -> np.ndarray:
        """Segmented full-intersection: row i = AND of the index color rows
        flat[sum(sizes[:i]) : +sizes[i]] (zeros when empty — no positive
        k-mers). Native parallel AND-reduce when the dense matrix is
        materialized (no (total_ids, W) intermediate, all cores); numpy
        gather + reduceat on the on-demand row path (150k-color regime)."""
        sizes = np.asarray(sizes, dtype=np.int64)
        starts_full = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts_full[1:])
        if self.idx._dense_bits is not None:
            from ..native import lib as native

            return native.and_reduce_rows(
                self.idx.dense_color_bits(),
                np.asarray(flat, dtype=np.int64), starts_full)
        # no-dense regime (150k-color): choose by measured density. SPARSE
        # sets (avg member count well under num_colors) intersect far
        # cheaper through their COMPRESSED member lists (sort-based
        # counting: a color is in the intersection of a segment's k sets
        # iff it occurs k times across their concatenation) than by
        # AND-ing 8 KB decoded rows. DENSE sets (core genes present in
        # nearly every color) invert that completely — the member lists
        # approach num_colors ints each — so they take the chunked
        # on-demand row path. ~8 ns/member vs ~1 ns/row-byte break-even.
        flat = np.asarray(flat, dtype=np.int64)
        _cat, offs = self._cs_cache
        total_members = int((offs[flat + 1] - offs[flat]).sum())
        row_bytes = len(flat) * self.idx.words_per_set * 4
        if total_members * 8 < row_bytes:
            return self._intersect_segments_lists(flat, sizes)
        return self._intersect_segments_rows(flat, sizes)

    def _intersect_segments_rows(self, flat: np.ndarray,
                                 sizes: np.ndarray) -> np.ndarray:
        """Chunked on-demand row gather + AND-reduce (bounded memory: the
        gathered (total_ids, W) block at 150k-color widths can reach tens
        of GB in one deferred-redo flush at 8 KB/row)."""
        starts_full = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts_full[1:])
        res = np.zeros((len(sizes), self.idx.words_per_set), dtype=np.uint32)
        nz = np.flatnonzero(sizes > 0)
        CHUNK = 1 << 16
        lo = 0
        while lo < len(nz):
            hi = lo + 1
            while (hi < len(nz)
                   and starts_full[nz[hi]] + sizes[nz[hi]]
                   - starts_full[nz[lo]] <= CHUNK):
                hi += 1
            seg = nz[lo:hi]
            base = starts_full[seg[0]]
            end = starts_full[seg[-1]] + sizes[seg[-1]]
            res[seg] = np.bitwise_and.reduceat(
                self.idx.color_rows(flat[base:end]),
                starts_full[seg] - base, axis=0
            )
            lo = hi
        return res

    def _intersect_segments_lists(self, flat: np.ndarray,
                                  sizes: np.ndarray) -> np.ndarray:
        from ..native import lib as native

        C = self.idx.num_colors
        W = self.idx.words_per_set
        cat, offs = self._cs_cache
        starts_full = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts_full[1:])
        res = np.zeros((len(sizes), W), dtype=np.uint32)
        set_len_all = (offs[flat + 1] - offs[flat]).astype(np.int64)
        # chunk segments so the concatenated member block stays bounded
        members_per_seg = np.zeros(len(sizes), dtype=np.int64)
        np.add.at(members_per_seg,
                  np.repeat(np.arange(len(sizes)), sizes), set_len_all)
        CHUNK = 32 << 20  # member ints per chunk (256 MB of u64 keys)
        lo = 0
        nseg = len(sizes)
        while lo < nseg:
            hi = lo + 1
            tot = members_per_seg[lo]
            while hi < nseg and tot + members_per_seg[hi] <= CHUNK:
                tot += members_per_seg[hi]
                hi += 1
            seg_sizes = sizes[lo:hi]
            f0, f1 = starts_full[lo], starts_full[hi]
            if f1 == f0:
                lo = hi
                continue
            fl = flat[f0:f1]
            sl = set_len_all[f0:f1]
            seg_of_flat = np.repeat(np.arange(hi - lo), seg_sizes)
            total = int(sl.sum())
            sub = np.arange(total, dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(sl)])[:-1], sl)
            colors = cat[np.repeat(offs[fl], sl) + sub].astype(np.int64)
            key = np.repeat(seg_of_flat, sl) * np.int64(C) + colors
            native.sort_i64(key)
            new = np.empty(len(key), dtype=bool)
            new[0] = True
            np.not_equal(key[1:], key[:-1], out=new[1:])
            gstart = np.flatnonzero(new)
            gcount = np.diff(np.concatenate([gstart, [len(key)]]))
            kv = key[gstart]
            seg_ids = kv // C
            cols = kv % C
            keep = gcount == seg_sizes[seg_ids]
            sel_seg = (seg_ids[keep] + lo).astype(np.int64)
            sel_col = cols[keep]
            native.or_bits_at(res, sel_seg, sel_col.astype(np.int64))
            lo = hi
        return res

    def _fi_rows_from_keys(self, keys: list) -> np.ndarray:
        """Vectorized full-intersection for MANY reads at once: keys[i] is
        read i's sorted-unique csid array (int64, no INVALID). One
        segmented AND-reduce over the concatenation replaces per-read
        intersect1d chains (~2.4 ms/read -> ~5 us/read at redo-batch
        sizes; the round-4 redo flood spent 160+ s here).
        -> (len(keys), words_per_set) u32 bitset rows."""
        if not keys:
            return np.zeros((0, self.idx.words_per_set), dtype=np.uint32)
        sizes = np.fromiter((len(u) for u in keys), dtype=np.int64,
                            count=len(keys))
        flat = (np.concatenate(keys) if sizes.sum()
                else np.empty(0, dtype=np.int64))
        return self._intersect_segments(flat, sizes)

    def _fi_rows_from_csid_matrix(self, rows_cs: np.ndarray,
                                  wlim: np.ndarray) -> np.ndarray:
        """Vectorized FI over a (n, Wk) window-csid matrix (INVALID where
        negative; windows past wlim[i] ignored): row-wise sort + dup mask
        replaces per-read np.unique, one reduceat intersects everything.
        -> (n, words_per_set) u32 bitset rows."""
        n, Wk = rows_cs.shape
        v = rows_cs.copy()
        v[np.arange(Wk)[None, :] >= np.asarray(wlim)[:, None]] = \
            np.uint32(INVALID_U32)
        s = np.sort(v, axis=1)
        keep = s != np.uint32(INVALID_U32)
        keep[:, 1:] &= s[:, 1:] != s[:, :-1]
        sizes = keep.sum(axis=1).astype(np.int64)
        return self._intersect_segments(s[keep].astype(np.int64), sizes)

    def _fi_lists_from_csids_many(self, csids_list: list) -> list:
        """Exact FI color lists for many reads from their window-csid
        arrays (INVALID entries = negative windows), vectorized through
        _fi_rows_from_keys."""
        keys = []
        for c in csids_list:
            c = np.asarray(c)
            keys.append(np.unique(c[c != INVALID_U32]).astype(np.int64))
        rows = self._fi_rows_from_keys(keys)
        lists, _ = self._bits_to_lists(rows, self.idx.num_colors)
        return lists

    def _tu_from_csids(self, csids: np.ndarray, threshold: float) -> np.ndarray:
        cat, offs = self._cs_cache
        pos = csids[csids != INVALID_U32]
        if len(pos) == 0:
            return np.empty(0, dtype=np.uint32)
        scores = np.zeros(self.idx.num_colors, dtype=np.int64)
        for sid in pos:
            scores[cat[offs[sid] : offs[sid + 1]].astype(np.int64)] += 1
        min_score = int(len(pos) * threshold)
        return np.flatnonzero(scores >= min_score).astype(np.uint32)

    def _redo_csids_inline(self, qid0, chunk, lens, js, query_path):
        """Exact per-window csids for batch rows `js` (overflow / too-long).
        Rows within the stream ladder re-probe from the chunk codes (no
        file re-parse); longer rows selectively re-parse from the file.
        -> list aligned with js."""
        from ..native import lib as native

        rows = []
        long_js = [int(j) for j in js if lens[j] > MAX_STREAM_WIDTH]
        long_map = {}
        if long_js:
            seqs, _names = native.parse_reads_select(
                query_path, [qid0 + j for j in long_js])
            long_map = dict(zip(long_js, seqs))
        for j in js:
            if lens[j] > MAX_STREAM_WIDTH:
                rows.append(np.asarray(long_map[int(j)], dtype=np.uint8))
            else:
                rows.append(chunk[j, : lens[j]])
        return self._redo_csids_rows(rows)

    def _redo_csids_rows(self, rows) -> list:
        """Exact per-window csids for materialized ragged rows. Small sets
        take the HOST exact probe: a device re-probe is a synchronous round
        trip that queues BEHIND the ~2 prefetched batch programs already on
        the device, while the vectorized host mirror touches no device
        state. Large pools (the deferred-redo flush) amortize that round
        trip over one big device dispatch; rows the device cannot decide
        exactly fall back to the host mirror."""
        if len(rows) <= 256:
            return self._host_csids_many(rows)
        csids = self._device_csids_many(rows)
        left = [i for i, c in enumerate(csids) if c is None]
        if left:
            for i, c in zip(left, self._host_csids_many([rows[i] for i in left])):
                csids[i] = c
        return csids

    def _selfcheck_batch(self, qid0, chunk, lens, n, get_colors, threshold,
                         skip=()):
        """FULGOR_SELFCHECK runtime oracle: for sampled reads, the color
        list about to be written must equal the exact host mirror's.
        get_colors(j) -> the final sorted uint32 list for batch row j.
        skip: batch rows deferred to the exact redo flush (which IS the
        host mirror, so checking them here would be circular anyway)."""
        period = self._selfcheck
        if not period:
            return
        start = (-qid0) % period
        for j in range(start, n, period):
            if lens[j] > MAX_STREAM_WIDTH or j in skip:
                continue  # long reads already go through the host mirror
            row = chunk[j, : lens[j]]
            want = (self._host_full_intersection(row) if threshold is None
                    else self._host_threshold(row, threshold))
            got = np.asarray(get_colors(j), dtype=np.uint32)
            if not np.array_equal(got, np.asarray(want, dtype=np.uint32)):
                raise RuntimeError(
                    f"FULGOR_SELFCHECK: read {qid0 + j} device result "
                    f"({len(got)} colors) != host mirror ({len(want)})"
                )
            self.num_selfchecked += 1

    @staticmethod
    def _colors_to_bits_row(colors, words: int) -> np.ndarray:
        """Sorted color-id list -> one (words,) u32 little-endian bitset row
        (the device result layout the bits formatters consume)."""
        row = np.zeros(words, dtype=np.uint32)
        if len(colors):
            c = np.asarray(colors, dtype=np.int64)
            np.bitwise_or.at(
                row, c >> 5, np.uint32(1) << (c & 31).astype(np.uint32))
        return row

    def _host_full_intersection(self, row_codes: np.ndarray) -> np.ndarray:
        return self._fi_from_csids(self._host_csids(row_codes))

    def _host_threshold(self, row_codes: np.ndarray, threshold: float) -> np.ndarray:
        return self._tu_from_csids(self._host_csids(row_codes), threshold)

    @staticmethod
    def _bits_to_lists(bits_np: np.ndarray, num_colors: int):
        bits_np = np.ascontiguousarray(bits_np)
        bm = np.unpackbits(bits_np.view(np.uint8), axis=1, bitorder="little")[
            :, :num_colors
        ].astype(bool)
        counts = bm.sum(axis=1)
        rows, cols = np.nonzero(bm)
        return np.split(cols.astype(np.uint32), np.cumsum(counts))[:-1], counts

    def _scores_to_lists(self, scores, npos, threshold):
        min_score = (npos.astype(np.float64) * threshold).astype(np.int64)
        bm = (scores >= min_score[:, None]) & (npos > 0)[:, None]
        counts = bm.sum(axis=1)
        rows, cols = np.nonzero(bm)
        return np.split(cols.astype(np.uint32), np.cumsum(counts))[:-1], counts

    # ---------------------------------------------------------------- array API

    def pseudoalign_codes(self, codes: np.ndarray, lens: np.ndarray, threshold=None):
        """-> list (per read, input order) of sorted uint32 color arrays."""
        N = len(lens)
        results: list = [None] * N
        C = self.idx.num_colors
        pending: deque = deque()
        done = []
        for sel, chunk in self._iter_batches(codes, lens):
            cr = self._color_runs(chunk.shape[1])
            if threshold is None:
                out = query_full_intersection(
                    self.table, self.bits, chunk, k=self.k, dparams=self.dparams,
                    color_runs=cr,
                )
            else:
                out = query_threshold_union(
                    self.table, self.bits, chunk, k=self.k, num_colors=C,
                    dparams=self.dparams, color_runs=cr,
                )
            pending.append((sel, out))
            # cap device batches in flight at 2 (each holds (B, C32)+
            # device results; unbounded dispatch exhausts device memory at
            # large inputs)
            if len(pending) > 2:
                sel0, out0 = pending.popleft()
                done.append((sel0, jax.tree.map(np.asarray, out0)))
        while pending:
            sel0, out0 = pending.popleft()
            done.append((sel0, jax.tree.map(np.asarray, out0)))
        for sel, out in done:
            nsel = len(sel)
            ovf = np.asarray(out[-1][:nsel])
            if threshold is None:
                lists, _ = self._bits_to_lists(np.asarray(out[0][:nsel]), C)
            else:
                lists, _ = self._scores_to_lists(
                    np.asarray(out[0][:nsel]), np.asarray(out[1][:nsel]), threshold
                )
            for j, ridx in enumerate(sel):
                if ovf[j]:  # rare: probe budget exhausted -> exact host redo
                    row = codes[ridx][: lens[ridx]]
                    results[ridx] = (
                        self._host_full_intersection(row)
                        if threshold is None
                        else self._host_threshold(row, threshold)
                    )
                else:
                    results[ridx] = lists[j]
        return results

    def pseudoalign_codes_dedup(self, codes: np.ndarray, lens: np.ndarray):
        """--deduplicate path (reference fetch_and_deduplicate_sets,
        tools/pseudoalign.cpp:91-226): fetch per-read distinct color-set-id
        lists, group identical lists, intersect each DISTINCT list once on
        host dense bits, then fan results back out to reads."""
        N = len(lens)
        C = self.idx.num_colors
        dense = self.idx.dense_color_bits()
        groups: dict[bytes, list[int]] = {}
        # <=2 device batches in flight (same cap as pseudoalign_codes):
        # overlaps dispatch with host grouping without accumulating every
        # batch's (B, Wk) csid buffers on the device for large inputs.
        from collections import deque

        pending: deque = deque()

        def _consume(sel, out):
            hit, csid, ovf = out
            csid = np.asarray(csid[: len(sel)])
            ovf_any = np.asarray(ovf[: len(sel)]).any(axis=1)
            s = np.sort(csid, axis=1)
            uniq_mask = np.concatenate(
                [np.ones((len(sel), 1), dtype=bool), s[:, 1:] != s[:, :-1]], axis=1
            ) & (s != INVALID_U32)
            for j, ridx in enumerate(sel):
                if ovf_any[j]:
                    c = self._host_csids(codes[ridx][: lens[ridx]])
                    key = np.unique(c[c != INVALID_U32]).tobytes()
                else:
                    key = s[j][uniq_mask[j]].tobytes()
                groups.setdefault(key, []).append(int(ridx))

        for sel, chunk in self._iter_batches(codes, lens):
            pending.append(
                (sel, query_window_csids(self.table, chunk, k=self.k,
                                         dparams=self.dparams))
            )
            if len(pending) > 2:
                _consume(*pending.popleft())
        while pending:
            _consume(*pending.popleft())
        results: list = [None] * N
        for key, readlist in groups.items():
            sids = np.frombuffer(key, dtype=np.uint32)
            if len(sids) == 0:
                colors = np.empty(0, dtype=np.uint32)
            else:
                acc = dense[sids.astype(np.int64)]
                word = acc[0].copy()
                for r in acc[1:]:
                    word &= r
                colors = np.flatnonzero(
                    np.unpackbits(word.view(np.uint8), bitorder="little")[:C]
                ).astype(np.uint32)
            for ridx in readlist:
                results[ridx] = colors
        return results

    def window_csids_codes(self, codes: np.ndarray, lens: np.ndarray):
        """-> list (per read) of (hit bool (W_r,), csid u32 (W_r,))."""
        out: list = [None] * len(lens)
        for sel, chunk in self._iter_batches(codes, lens):
            hit, csid, ovf = query_window_csids(self.table, chunk, k=self.k,
                                                dparams=self.dparams)
            hit = np.asarray(hit[: len(sel)])
            csid = np.asarray(csid[: len(sel)])
            ovf_any = np.asarray(ovf[: len(sel)]).any(axis=1)
            for j, ridx in enumerate(sel):
                w = max(0, int(lens[ridx]) - self.k + 1)
                if w > hit.shape[1] or ovf_any[j]:  # too long / ovf: host path
                    c = self._host_csids(codes[ridx][: lens[ridx]])
                    out[ridx] = (c != INVALID_U32, c)
                else:
                    out[ridx] = (hit[j, :w], csid[j, :w])
        return out

    # ---------------------------------------------------------------- streaming core

    def _mesh_dispatch(self, chunk, threshold, C):
        """Sharded dispatch for one packed chunk (exact: max_runs = #windows)."""
        M = self._mesh_mod
        W = chunk.shape[1]
        codes2, bad = pack_reads_host(chunk)
        codes2, bad = M.place_packed(self.mesh, codes2, bad)
        max_runs = W - self.k + 1
        key = ("fi" if threshold is None else "tu", W)
        if key not in self._mesh_fns:
            if threshold is None:
                self._mesh_fns[key] = M.make_sharded_full_intersection_packed(
                    self.mesh, self.k, W, max_runs, dparams=self.dparams
                )
            else:
                self._mesh_fns[key] = M.make_sharded_threshold_union_packed(
                    self.mesh, self.k, W, self.bits.shape[1] * 32, max_runs,
                    dparams=self.dparams,
                )
        out = self._mesh_fns[key](self.table, self.bits, codes2, bad)
        if threshold is None:
            return out[0], out[2]  # (B, C32pad) result bits, ovf
        return out[0][:, :C], out[1], out[2]  # scores (slice pad), npos, ovf

    def _stream(self, query_path: str, dispatch, consume, need_names=False,
                progress=False, shard=None):
        """Streaming driver: parse chunk -> dispatch(chunk)->device handles
        (<=2 in flight) -> consume(qid0, n, lens, names, handle, chunk).
        Returns (num_reads_total, long_read_qids, parse_sec). progress: log
        a counter every 2^20 reads (reference src/ps_utils.cpp:421-428).

        Parsing runs on a prefetch thread (the native parser releases the
        GIL), overlapping with device dispatch and host formatting.

        shard=(proc_id, num_procs): multi-host data parallelism — only
        chunks with index % num_procs == proc_id are dispatched; the rest
        are parsed (to keep read ids GLOBAL file ordinals) and dropped.
        qids passed to consume and returned in long_read_qids are global,
        so per-process fragments merge by id into the single-host output
        (parallel/multihost.py). num_reads_total stays the whole file's
        count."""
        import queue
        import threading

        from ..native.lib import ReadsStream

        stream = ReadsStream(query_path, self.batch, row_len=MAX_STREAM_WIDTH)
        q: queue.Queue = queue.Queue(maxsize=2)
        parse_sec = [0.0]
        pid, nprocs = shard if shard is not None else (0, 1)

        def producer():
            try:
                t = time.perf_counter()
                base = 0
                for ci, (codes, lens, names) in enumerate(stream):
                    parse_sec[0] += time.perf_counter() - t
                    if ci % nprocs == pid:
                        # copy out of the stream's reused buffers
                        q.put((codes.copy(), lens, names, base))
                    base += len(lens)
                    t = time.perf_counter()
                parse_sec[0] += time.perf_counter() - t
                q.put(("total", base))
            except BaseException as e:  # surface parse failures to the consumer
                q.put(e)

        th = threading.Thread(target=producer, daemon=True)
        th.start()

        total = [0]

        def chunks():
            while True:
                item = q.get()
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "total":
                    total[0] = item[1]
                    break
                if isinstance(item, BaseException):
                    th.join()
                    raise item
                yield item
            th.join()

        inflight: deque = deque()
        seen = 0
        long_ids: list[int] = []
        next_report = 1 << 20
        for codes, lens, names, base in chunks():
            if progress and seen >= next_report:
                import sys as _sys

                print(f"processed {seen} reads", file=_sys.stderr)
                while next_report <= seen:
                    next_report += 1 << 20
            n = len(lens)
            maxl = int(lens.max()) if n else 0
            too_long = lens > MAX_STREAM_WIDTH
            if too_long.any():
                long_ids.extend((base + np.flatnonzero(too_long)).tolist())
            W = self._width_for(min(maxl, MAX_STREAM_WIDTH))
            # Lane budget: one long read in a chunk widens the whole batch
            # (its codes row rides along truncated; the exact answer comes
            # from the long-read host path). At W=1024 a full 32k batch is
            # 32.6M probe lanes. Sub-batch so B_eff*(W-k+1) stays within
            # the device's lane budget; compile shapes stay bounded (one
            # B_eff per ladder width).
            B_eff = self._batch_for_width(W)
            for lo in range(0, max(n, 1), B_eff):
                n_sub = min(B_eff, n - lo) if n else 0
                chunk = np.ascontiguousarray(codes[lo:lo + n_sub, :W])
                if n_sub < B_eff:
                    pad = np.full((B_eff - n_sub, W), 4, dtype=np.uint8)
                    chunk = np.concatenate([chunk, pad], axis=0)
                handle = dispatch(chunk)
                inflight.append((
                    base + lo, n_sub, lens[lo:lo + n_sub],
                    names[lo:lo + n_sub] if need_names else None, handle, chunk,
                ))
                if len(inflight) > 2:
                    consume(*inflight.popleft())
            seen += n
        while inflight:
            consume(*inflight.popleft())
        return total[0], long_ids, parse_sec[0], seen

    # ---------------------------------------------------------------- file drivers

    def pseudoalign_file(
        self,
        query_path: str,
        out_path: str,
        threshold=None,
        fmt: str = "ascii",
        verbose: bool = False,
        deduplicate: bool = False,
        shard=None,
    ):
        C = self.idx.num_colors
        t0 = time.perf_counter()
        checked0 = self.num_selfchecked

        if deduplicate:
            return self._pseudoalign_dedup_stream(query_path, out_path, threshold,
                                                  fmt, verbose, t0)

        inner = make_formatter(fmt, out_path, C)
        fmtr = AsyncWriter(inner)
        fmtr.has_bits = hasattr(inner, "write_batch_bits")
        fmtr.has_grouped = hasattr(inner, "write_batch_bits_grouped")
        num_reads = 0
        query_sec = 0.0
        host_sec = 0.0  # host-side result reduction (dedup-intersect etc.)
        num_redo = 0  # reads redone inline (overflow / past the ladder)
        redo_sec = 0.0

        runs_fetch = (self.use_runs_fetch and fmtr.has_bits
                      and threshold is None and not self.use_lists)
        tu_runs = (self.use_tu_runs and threshold is not None
                   and not self.use_lists)
        tu_bits = (self.use_tu_bits and fmtr.has_bits
                   and threshold is not None and not self.use_lists)

        def dispatch(chunk):
            W = chunk.shape[1]
            if runs_fetch or tu_runs:
                # no-dense-matrix fetches work under a mesh too: the probe
                # is data-parallel and ships only (csid[, count]) runs.
                # Without streaming locality the budget is the full window
                # count (exact, no overflow) — only reached in the
                # dense-infeasible x shredded corner.
                codes2, bad = pack_reads_host(chunk)
                R = (min(self._runs_R, W - self.k + 1) if self._runs_ok
                     else W - self.k + 1)
                if self.mesh is not None:
                    key = ("fi_runs" if runs_fetch else "tu_runs", W, R)
                    if key not in self._mesh_fns:
                        mk = (self._mesh_mod.make_sharded_distinct_runs
                              if runs_fetch
                              else self._mesh_mod.make_sharded_runs_tu)
                        self._mesh_fns[key] = mk(self.mesh, self.k, W, R,
                                                 dparams=self.dparams)
                    codes2, bad = self._mesh_mod.place_packed(self.mesh,
                                                              codes2, bad)
                    out = self._mesh_fns[key](self.table, codes2, bad)
                    return _prefetch(out, skip=(3,) if runs_fetch else ())
                if runs_fetch:
                    return _prefetch(query_distinct_runs_packed(
                        self.table, codes2, bad, k=self.k, width=W, R=R,
                        dparams=self.dparams, probe_budget=self._pb,
                    ), skip=(3,))
                return _prefetch(query_runs_tu_packed(
                    self.table, codes2, bad, k=self.k, width=W, R=R,
                    dparams=self.dparams, probe_budget=self._pb,
                ))
            if self.mesh is not None:
                return self._mesh_dispatch(chunk, threshold, C)
            codes2, bad = pack_reads_host(chunk)
            cr = self._color_runs(W)
            if tu_bits:
                # threshold union: >= min_score moved on device, ship the
                # passing-color lists instead of (C,) scores
                return _prefetch(query_tu_lists_packed(
                    self.table, self.bits, codes2, bad,
                    self._minscore_tab(threshold, W - self.k + 1),
                    k=self.k, width=W, num_colors=C, T=T_LIST,
                    dparams=self.dparams, color_runs=cr, probe_budget=self._pb,
                ))
            if self.use_lists:
                if threshold is None:
                    return _prefetch(query_fi_lists_packed(
                        self.table, self.bits, codes2, bad, k=self.k, width=W,
                        T=T_LIST, dparams=self.dparams, color_runs=cr,
                        probe_budget=self._pb,
                    ))
                return _prefetch(query_tu_lists_packed(
                    self.table, self.bits, codes2, bad,
                    self._minscore_tab(threshold, W - self.k + 1),
                    k=self.k, width=W, num_colors=C, T=T_LIST,
                    dparams=self.dparams, color_runs=cr, probe_budget=self._pb,
                ))
            if threshold is None:
                return _prefetch(query_full_intersection_packed(
                    self.table, self.bits, codes2, bad, k=self.k,
                    width=W, dparams=self.dparams, color_runs=cr,
                    probe_budget=self._pb,
                ))
            return _prefetch(query_threshold_union_packed(
                self.table, self.bits, codes2, bad,
                k=self.k, width=W, num_colors=C,
                dparams=self.dparams, color_runs=cr, probe_budget=self._pb,
            ))

        # DEFERRED redo pool: overflow / too-long reads are stashed here and
        # resolved in one amortized exact dispatch per FLUSH boundary instead
        # of a synchronous per-batch device round trip (each round trip
        # waits behind the ~2 prefetched batch programs).
        # Stragglers therefore trail in the output (module contract:
        # in-order except overflow/long-read stragglers).
        deferred: list = []  # (global read id, codes u8 | None = re-parse)
        flush_at = int(_os.environ.get("FULGOR_REDO_FLUSH", "8192"))
        # under multihost sharding, stragglers go to a `.redo` side
        # fragment so the MAIN fragment stays strictly id-ascending and
        # the cross-host merge can stream (parallel/multihost.py)
        redo_fmtr = None

        def redo_sink():
            nonlocal redo_fmtr
            if shard is None:
                return fmtr
            if redo_fmtr is None:
                redo_fmtr = AsyncWriter(
                    make_formatter(fmt, out_path + ".redo", C))
            return redo_fmtr

        def defer_reads(qid0, chunk, lens, js):
            """Stash batch rows js for the next redo flush; -> set of js
            for write exclusion."""
            out = set()
            for j in js:
                j = int(j)
                out.add(j)
                if lens[j] > MAX_STREAM_WIDTH:
                    deferred.append((qid0 + j, None))
                else:
                    deferred.append((qid0 + j, chunk[j, : lens[j]].copy()))
            return out

        # in-flight redo dispatches: (ids, rows, device state). A flush
        # DISPATCHES the exact re-probe and resolves it one flush-interval
        # later (or at EOF), so the redo programs interleave with the main
        # batch programs instead of serializing a device round trip into
        # the consume path.
        pending_redo: list = []

        def _write_redo(ids, csids):
            nonlocal num_redo
            if threshold is None:
                lists = self._fi_lists_from_csids_many(csids)
            else:
                lists = [self._tu_from_csids(np.asarray(c), threshold)
                         for c in csids]
            redo_sink().write_batch(ids, lists)
            num_redo += len(ids)

        def flush_deferred(final=False):
            nonlocal num_redo, redo_sec
            tr = time.perf_counter()
            if deferred and (final or len(deferred) >= flush_at):
                from ..native import lib as native

                long_pos = [i for i, (_, r) in enumerate(deferred)
                            if r is None]
                if long_pos:
                    seqs, _nm = native.parse_reads_select(
                        query_path, [deferred[i][0] for i in long_pos])
                    for i, s in zip(long_pos, seqs):
                        deferred[i] = (deferred[i][0],
                                       np.asarray(s, dtype=np.uint8))
                ids = [q for q, _ in deferred]
                rows = [r for _, r in deferred]
                deferred.clear()
                if len(rows) <= 256:
                    # small pools: the vectorized host mirror touches no
                    # device state
                    _write_redo(ids, self._host_csids_many(rows))
                else:
                    pending_redo.append(
                        (ids, rows, self._device_csids_dispatch(rows)))
            while pending_redo and (final or len(pending_redo) >= 2):
                ids, rows, state = pending_redo.pop(0)
                csids = self._device_csids_resolve(rows, state)
                left = [i for i, c in enumerate(csids) if c is None]
                if left:
                    for i, c in zip(left, self._host_csids_many(
                            [rows[i] for i in left])):
                        csids[i] = c
                _write_redo(ids, csids)
            redo_sec += time.perf_counter() - tr

        def consume_lists(qid0, n, lens, _names, handle, chunk):
            nonlocal num_reads, query_sec
            tq = time.perf_counter()
            cnt = np.asarray(handle[0][:n])
            lists = np.asarray(handle[1][:n])
            ovf = np.asarray(handle[3][:n])
            keep = (lens <= MAX_STREAM_WIDTH) & ~ovf
            over = np.flatnonzero(keep & (cnt > T_LIST))
            rows_over = self._fetch_rows(handle[2], over)
            tw = time.perf_counter()
            query_sec += tw - tq
            if (ovf.mean() > 0.15 and not self._cr_off
                    and self._color_runs(chunk.shape[1]) is not None):
                self._cr_off = True  # runs not compacting: per-window next
            dropped = defer_reads(qid0, chunk, lens, np.flatnonzero(~keep))
            om = {}
            if len(over):
                over_lists, _ = self._bits_to_lists(rows_over, C)
                om.update(zip(over.tolist(), over_lists))
            wr = np.flatnonzero(keep)
            colors = {
                int(j): om[j] if j in om else lists[j, : cnt[j]].astype(np.uint32)
                for j in wr
            }
            self._selfcheck_batch(qid0, chunk, lens, n,
                                  lambda j: colors[j], threshold, skip=dropped)
            fmtr.write_batch([qid0 + int(j) for j in wr],
                             [colors[int(j)] for j in wr])
            num_reads += n
            flush_deferred()

        def consume(qid0, n, lens, _names, handle, chunk):
            nonlocal num_reads, query_sec
            tq = time.perf_counter()
            if threshold is None:
                fetched = np.asarray(handle[0][:n])
                ovf = np.asarray(handle[1][:n])
            else:
                fetched = (np.asarray(handle[0][:n]), np.asarray(handle[1][:n]))
                ovf = np.asarray(handle[2][:n])
            tw = time.perf_counter()
            query_sec += tw - tq
            keep = (lens <= MAX_STREAM_WIDTH) & ~ovf
            if (ovf.mean() > 0.15 and not self._cr_off
                    and self._color_runs(chunk.shape[1]) is not None):
                self._cr_off = True  # runs not compacting: per-window next
            dropped = defer_reads(qid0, chunk, lens, np.flatnonzero(~keep))
            wr = np.flatnonzero(keep)
            num_reads += n
            if threshold is None and fmtr.has_bits:
                # fast path: native bits->ascii straight from the device's
                # result layout, no per-read list expansion (deferred rows
                # are excluded from the write and flushed later)
                self._selfcheck_batch(
                    qid0, chunk, lens, n,
                    lambda j: self._bits_to_lists(fetched[j : j + 1], C)[0][0],
                    threshold, skip=dropped)
                fmtr.write_batch_bits(
                    qid0 + wr.astype(np.uint32), fetched[wr])
                flush_deferred()
                return
            if threshold is None:
                lists, _counts = self._bits_to_lists(fetched, C)
            else:
                lists, _counts = self._scores_to_lists(
                    fetched[0].astype(np.int64), fetched[1], threshold
                )
            self._selfcheck_batch(qid0, chunk, lens, n,
                                  lambda j: lists[j], threshold, skip=dropped)
            fmtr.write_batch([qid0 + int(j) for j in wr],
                             [lists[j] for j in wr])
            flush_deferred()

        def consume_runs(qid0, n, lens, _names, handle, chunk):
            # FI via distinct run csids: normalize each read's <=R csids to a
            # sorted-unique key, intersect once per DISTINCT key on the host
            # dense rows, fan results back out as bitset rows
            nonlocal num_reads, num_redo, query_sec, host_sec, redo_sec
            tq = time.perf_counter()
            runs = np.asarray(handle[0][:n])
            povf = np.asarray(handle[1][:n])
            rovf = np.asarray(handle[2][:n])
            th = time.perf_counter()
            query_sec += th - tq
            if rovf.mean() > 0.02 and self._runs_R == RUNS_FI_BUDGET:
                self._runs_R = 2 * RUNS_FI_BUDGET  # escalate later batches
            fit = lens <= MAX_STREAM_WIDTH
            keep = fit & ~povf & ~rovf
            # run-budget-only overflow (>R distinct runs, probe decided all
            # windows): the device-resident per-window csids are EXACT —
            # gather just those rows and intersect them like any other key.
            # No re-probe, no per-read host path (the round-4 flood: 12% of
            # pansal4546 reads exceeded R=48 and burned 160+ s here).
            ro = np.flatnonzero(fit & rovf & ~povf)
            ro_res = None
            if len(ro):
                tr = time.perf_counter()
                rows_cs = self._fetch_rows(handle[3], ro)
                wlim = np.maximum(0, lens[ro].astype(np.int64) - self.k + 1)
                ro_res = self._fi_rows_from_csid_matrix(rows_cs, wlim)
                num_redo += len(ro)
                redo_sec += time.perf_counter() - tr
            dropped = defer_reads(qid0, chunk, lens,
                                  np.flatnonzero(~fit | (povf & fit)))
            num_reads += n
            s = np.sort(runs, axis=1)
            dup = np.zeros_like(s, dtype=bool)
            dup[:, 1:] = s[:, 1:] == s[:, :-1]
            s[dup] = np.uint32(INVALID_U32)
            s.sort(axis=1)
            kj = np.flatnonzero(keep)
            # void-view row dedup: same (keys, inv) contract as
            # np.unique(axis=0) minus its per-column lexsort (~7x faster at
            # (32k, 48); key ORDER is byte-lex, which nothing downstream
            # depends on)
            sk = np.ascontiguousarray(s[kj])
            v = sk.view([("", sk.dtype, sk.shape[1])]).ravel()
            _, kidx, inv = np.unique(v, return_index=True, return_inverse=True)
            keys = sk[kidx]
            # cross-batch cache: only MISSING keys pay the segmented
            # AND-reduce (native when the dense matrix exists; on-demand
            # row decode at 150k-color scale)
            cache = self._fi_key_cache
            kb = keys.tobytes()
            rowlen = keys.shape[1] * 4
            res = np.empty((len(keys), self.idx.words_per_set),
                           dtype=np.uint32)
            miss = []
            for i in range(len(keys)):
                r = cache.get(kb[i * rowlen: (i + 1) * rowlen])
                if r is None:
                    miss.append(i)
                else:
                    res[i] = r
            if miss:
                mk = keys[miss]
                mvalid = mk != np.uint32(INVALID_U32)
                msz = mvalid.sum(axis=1).astype(np.int64)
                mres = self._intersect_segments(
                    mk[mvalid].astype(np.int64), msz)
                res[miss] = mres
                if len(cache) + len(miss) > self._fi_key_cache_cap:
                    cache.clear()
                for i, row in zip(miss, mres):
                    cache[kb[i * rowlen: (i + 1) * rowlen]] = row
            # run-overflow rows join as extra bodies so the batch writes
            # once; deferred (probe-overflow / too-long) rows are excluded
            # and flushed later
            full_inv = np.empty(n, dtype=np.int32)
            full_inv[kj] = inv.astype(np.int32)
            if ro_res is not None:
                full_inv[ro] = len(res) + np.arange(len(ro), dtype=np.int32)
                res = np.vstack([res, ro_res])
            wmask = np.zeros(n, dtype=bool)
            wmask[kj] = True
            if len(ro):
                wmask[ro] = True
            wr = np.flatnonzero(wmask)
            ids = np.arange(qid0, qid0 + n, dtype=np.uint32)
            self._selfcheck_batch(
                qid0, chunk, lens, n,
                lambda j: self._bits_to_lists(
                    res[full_inv[j]][None, :], C)[0][0],
                threshold, skip=dropped)
            if getattr(fmtr, "has_grouped", False):
                # each DISTINCT result body formats once (reads in a batch
                # heavily share full-intersection results)
                fmtr.write_batch_bits_grouped(ids[wr], res, full_inv[wr])
            else:
                fmtr.write_batch_bits(ids[wr], res[full_inv[wr]])
            host_sec += time.perf_counter() - th
            flush_deferred()

        def consume_tubits(qid0, n, lens, _names, handle, chunk):
            nonlocal num_reads, query_sec
            tq = time.perf_counter()
            maskbits = np.asarray(handle[2][:n])
            ovf = np.asarray(handle[3][:n])
            query_sec += time.perf_counter() - tq
            keep = (lens <= MAX_STREAM_WIDTH) & ~ovf
            if (ovf.mean() > 0.15 and not self._cr_off
                    and self._color_runs(chunk.shape[1]) is not None):
                self._cr_off = True  # runs not compacting: per-window next
            dropped = defer_reads(qid0, chunk, lens, np.flatnonzero(~keep))
            wr = np.flatnonzero(keep)
            num_reads += n
            self._selfcheck_batch(
                qid0, chunk, lens, n,
                lambda j: self._bits_to_lists(maskbits[j : j + 1], C)[0][0],
                threshold, skip=dropped)
            fmtr.write_batch_bits(qid0 + wr.astype(np.uint32), maskbits[wr])
            flush_deferred()

        def consume_tu_runs(qid0, n, lens, _names, handle, chunk):
            # TU without any dense matrix: host scores each read's (csid,
            # count) runs against on-demand decoded member lists (reference
            # merge semantics, src/ps_threshold_union.cpp:354-399)
            nonlocal num_reads, query_sec, host_sec
            tq = time.perf_counter()
            rc = np.asarray(handle[0][:n])
            cnts = np.asarray(handle[1][:n])
            npos = np.asarray(handle[2][:n])
            ovf = np.asarray(handle[3][:n])
            th = time.perf_counter()
            query_sec += th - tq
            keep = (lens <= MAX_STREAM_WIDTH) & ~ovf
            dropped = defer_reads(qid0, chunk, lens, np.flatnonzero(~keep))
            wr = np.flatnonzero(keep)
            num_reads += n
            cat, offs = self._cs_cache
            lists = {}
            scores = np.zeros(C, dtype=np.int64)
            for j in wr:
                j = int(j)
                v = rc[j] != np.uint32(INVALID_U32)
                if npos[j] <= 0 or not v.any():
                    lists[j] = np.empty(0, dtype=np.uint32)
                    continue
                scores[:] = 0
                for sid, w in zip(rc[j][v].astype(np.int64),
                                  cnts[j][v].astype(np.int64)):
                    scores[cat[offs[sid] : offs[sid + 1]].astype(np.int64)] += w
                ms = int(float(npos[j]) * threshold)
                lists[j] = np.flatnonzero(scores >= ms).astype(np.uint32)
            self._selfcheck_batch(qid0, chunk, lens, n,
                                  lambda j: lists[j], threshold, skip=dropped)
            fmtr.write_batch([qid0 + int(j) for j in wr],
                             [lists[int(j)] for j in wr])
            host_sec += time.perf_counter() - th
            flush_deferred()

        if runs_fetch:
            consume = consume_runs
        elif tu_runs:
            consume = consume_tu_runs
        elif tu_bits:
            consume = consume_tubits
        elif self.use_lists:
            consume = consume_lists

        total, _long_ids, parse_sec, _own = self._stream(
            query_path, dispatch, consume, progress=verbose, shard=shard)
        flush_deferred(final=True)
        fmtr.close()
        num_mapped = fmtr.mapped
        write_sec = fmtr.busy_sec
        if redo_fmtr is not None:
            redo_fmtr.close()
            num_mapped += redo_fmtr.mapped
            write_sec += redo_fmtr.busy_sec

        elapsed = time.perf_counter() - t0
        # per-stage busy times; stages overlap (parse on a prefetch thread,
        # device compute async, formatting/IO on the writer thread), so
        # their sum can exceed `elapsed`.
        stats = dict(
            num_reads=num_reads,
            num_reads_total=total,
            num_mapped=num_mapped,
            parse_sec=parse_sec,
            query_sec=query_sec,
            host_sec=host_sec,
            write_sec=write_sec,
            num_redo=num_redo,
            redo_sec=redo_sec,
        )
        if self._selfcheck:
            stats["num_selfchecked"] = self.num_selfchecked - checked0
        if verbose:
            self._print_stats(stats, elapsed)
        return stats

    def _pseudoalign_dedup_stream(self, query_path, out_path, threshold, fmt,
                                  verbose, t0):
        """--deduplicate: stream the reads once fetching per-read distinct
        color-set-id lists (reference fetch_and_deduplicate_sets,
        tools/pseudoalign.cpp:92-226, which likewise keeps only csid lists
        in memory/tmp-file, never the sequences), group identical lists,
        intersect each DISTINCT list once, fan back out in read order."""
        from ..native import lib as native

        assert threshold is None, "--deduplicate requires full-intersection"
        C = self.idx.num_colors
        groups: dict[bytes, list[int]] = {}

        ovf_ids: list[int] = []

        def dispatch(chunk):
            # compacted (csid, run) fetch: the distinct-set key needs only
            # the <=R run ids, not every window's csid
            W = chunk.shape[1]
            codes2, bad = pack_reads_host(chunk)
            if self.mesh is not None:
                key = ("dedup", W)
                if key not in self._mesh_fns:
                    self._mesh_fns[key] = self._mesh_mod.make_sharded_distinct_runs(
                        self.mesh, self.k, W, 2 * _runs_budget(W, self._ekpu, self.k),
                        dparams=self.dparams,
                    )
                codes2, bad = self._mesh_mod.place_packed(self.mesh, codes2, bad)
                return self._mesh_fns[key](self.table, codes2, bad)
            return query_distinct_runs_packed(
                self.table, codes2, bad, k=self.k, width=W,
                R=2 * _runs_budget(W, self._ekpu, self.k), dparams=self.dparams,
                probe_budget=self._pb,
            )

        def consume(qid0, n, lens, _names, handle, _chunk):
            runs = np.asarray(handle[0][:n])
            povf = np.asarray(handle[1][:n])
            rovf = np.asarray(handle[2][:n])
            s = np.sort(runs, axis=1)
            uniq = np.concatenate(
                [np.ones((n, 1), dtype=bool), s[:, 1:] != s[:, :-1]], axis=1
            ) & (s != INVALID_U32)
            fit = lens <= MAX_STREAM_WIDTH
            keep = fit & ~povf & ~rovf
            # run-budget-only overflow: gather the exact device-resident
            # window csids for those rows (same recovery as consume_runs)
            ro = np.flatnonzero(fit & rovf & ~povf)
            if len(ro):
                rows_cs = self._fetch_rows(handle[3], ro)
                wlim = np.maximum(0, lens[ro].astype(np.int64) - self.k + 1)
                for t, j in enumerate(ro):
                    u = rows_cs[t, : wlim[t]]
                    u = np.unique(u[u != np.uint32(INVALID_U32)])
                    groups.setdefault(u.tobytes(), []).append(qid0 + int(j))
            ovf_ids.extend((qid0 + np.flatnonzero(povf & fit)).tolist())
            for j in range(n):
                if not keep[j]:
                    continue
                groups.setdefault(s[j][uniq[j]].tobytes(), []).append(qid0 + j)

        total, long_ids, parse_sec, _own = self._stream(query_path, dispatch,
                                                        consume)
        redo = sorted(set(long_ids) | set(ovf_ids))
        if redo:
            seqs, _names = native.parse_reads_select(query_path, redo)
            for qid, row in zip(redo, seqs):
                c = self._host_csids(row)
                key = np.unique(c[c != INVALID_U32]).tobytes()
                groups.setdefault(key, []).append(qid)

        results: list = [None] * total
        # one vectorized gather+reduceat over every distinct key (on-demand
        # row decode: no dense matrix needed at large C)
        gkeys = list(groups.keys())
        key_arrs = [np.frombuffer(kb, dtype=np.uint32).astype(np.int64)
                    for kb in gkeys]
        lists, _ = self._bits_to_lists(self._fi_rows_from_keys(key_arrs), C)
        for kb, colors in zip(gkeys, lists):
            for ridx in groups[kb]:
                results[ridx] = colors
        fmtr = make_formatter(fmt, out_path, C)
        B = 1 << 16
        for lo in range(0, total, B):
            fmtr.write_batch(range(lo, min(total, lo + B)), results[lo: lo + B])
        fmtr.close()
        num_mapped = sum(1 for r in results if len(r))
        elapsed = time.perf_counter() - t0
        stats = dict(num_reads=total, num_mapped=num_mapped,
                     parse_sec=parse_sec, query_sec=elapsed - parse_sec,
                     write_sec=0.0)
        if verbose:
            self._print_stats(stats, elapsed)
        return stats

    @staticmethod
    def _print_stats(stats, elapsed):
        n = max(1, stats["num_reads"])
        print(f"mapped {stats['num_reads']} reads")
        print(
            f"elapsed = {elapsed * 1e3:.0f} millisec / {elapsed:.3f} sec / "
            f"{elapsed / 60:.5f} min / {elapsed * 1e6 / n:.4f} musec/read"
        )
        print(
            f"num_mapped_reads {stats['num_mapped']}/{stats['num_reads']} "
            f"({100.0 * stats['num_mapped'] / n:.3f}%)"
        )
        # busy time per overlapped stage (parse runs on the prefetch thread,
        # device compute is async) — the sum can legitimately exceed elapsed
        print(
            f"stage busy: parse {stats.get('parse_sec', 0.0):.3f}s "
            f"query {stats.get('query_sec', 0.0):.3f}s "
            f"host {stats.get('host_sec', 0.0):.3f}s "
            f"write {stats.get('write_sec', 0.0):.3f}s"
        )
        if "num_selfchecked" in stats:
            print(f"selfcheck: {stats['num_selfchecked']} sampled reads "
                  f"equal the host mirror")

    def kmer_conservation_file(self, query_path: str, out_path: str, verbose=False):
        from ..native import lib as native

        f = open(out_path, "wb", buffering=1 << 20)
        num_redo = 0
        query_sec = 0.0  # result fetch wait
        host_sec = 0.0   # run flatten + native format + file write

        def write_one(name, hit, csid):
            triples = conservation_runs(hit, csid)
            if triples:
                body = "\t".join(f"({p} {nn} {i})" for p, nn, i in triples)
                f.write(f"{name}\t{len(triples)}\t{body}\n".encode())
            else:
                f.write(f"{name}\t0\n".encode())

        def dispatch(chunk):
            # device-side run extraction: fetch <=R (csid, start, len)
            # records per read instead of every window's csid
            W = chunk.shape[1]
            codes2, bad = pack_reads_host(chunk)
            if self.mesh is not None:
                key = ("kc", W)
                if key not in self._mesh_fns:
                    self._mesh_fns[key] = (
                        self._mesh_mod.make_sharded_conservation_runs(
                            self.mesh, self.k, W, _runs_budget(W, self._ekpu, self.k),
                            dparams=self.dparams,
                        )
                    )
                codes2, bad = self._mesh_mod.place_packed(self.mesh, codes2, bad)
                return self._mesh_fns[key](self.table, codes2, bad)
            return _prefetch(query_conservation_runs_packed(
                self.table, codes2, bad, k=self.k, width=W,
                R=_runs_budget(W, self._ekpu, self.k), dparams=self.dparams,
                probe_budget=self._pb,
            ))

        def consume(qid0, n, lens, names, handle, chunk):
            nonlocal num_redo, query_sec, host_sec
            tq = time.perf_counter()
            rc = np.asarray(handle[0][:n])
            rs = np.asarray(handle[1][:n]).astype(np.uint32)
            rl = np.asarray(handle[2][:n]).astype(np.uint32)
            ovf_any = np.asarray(handle[3][:n])
            th = time.perf_counter()
            query_sec += th - tq
            keep = (lens <= MAX_STREAM_WIDTH) & ~ovf_any
            bad = np.flatnonzero(~keep)
            num_redo += len(bad)
            # inline redo (id-ordered output): exact window csids for
            # overflow/long rows, interleaved between the kept segments
            exact = {}
            if len(bad):
                for j, c in zip(bad, self._redo_csids_inline(
                        qid0, chunk, lens, bad, query_path)):
                    exact[int(j)] = c
            if not len(bad):
                kj = np.arange(n)
                # row-major boolean flatten keeps per-read run order
                v = rc[kj] != INVALID_U32
                run_offs = np.zeros(len(kj) + 1, dtype=np.int64)
                np.cumsum(v.sum(axis=1), out=run_offs[1:])
                f.write(native.format_kc(
                    [names[j] for j in kj], rs[kj][v], rl[kj][v], rc[kj][v],
                    run_offs,
                ))
                host_sec += time.perf_counter() - th
                return
            seg_start = 0
            for j in list(bad) + [n]:
                kj = np.arange(seg_start, j)
                if len(kj):
                    v = rc[kj] != INVALID_U32
                    run_offs = np.zeros(len(kj) + 1, dtype=np.int64)
                    np.cumsum(v.sum(axis=1), out=run_offs[1:])
                    f.write(native.format_kc(
                        [names[jj] for jj in kj],
                        rs[kj][v], rl[kj][v], rc[kj][v], run_offs,
                    ))
                if j < n:
                    c = exact[int(j)]
                    write_one(names[j], c != INVALID_U32, c)
                seg_start = j + 1
            host_sec += time.perf_counter() - th

        total, _long_ids, parse_sec, _own = self._stream(
            query_path, dispatch, consume, need_names=True, progress=verbose)
        f.close()
        return dict(num_reads=total, num_redo=num_redo, parse_sec=parse_sec,
                    query_sec=query_sec, host_sec=host_sec)

    def kmer_matches_file(self, query_path: str, out_path: str, verbose=False):
        from ..native import lib as native

        cat, offs = self._cs_cache
        C = self.idx.num_colors
        f = open(out_path, "wb", buffering=1 << 20)
        f.write(f"num_colors={C}\n".encode())
        num_redo = 0

        def write_one(name, hit, csid):
            counts = np.zeros(C, dtype=np.int64)
            for sid in csid[hit]:
                counts[cat[offs[sid] : offs[sid + 1]].astype(np.int64)] += 1
            wpr = max(1, (len(hit) + 31) // 32)
            hw = np.packbits(
                np.pad(hit, (0, wpr * 32 - len(hit))), bitorder="little"
            ).view(np.uint32)[None, :]
            f.write(
                native.format_km(
                    [name], hw, np.array([len(hit)], np.int32), counts[None, :]
                )
            )

        def dispatch(chunk):
            W = chunk.shape[1]
            codes2, bad = pack_reads_host(chunk)
            if self.mesh is not None:
                key = ("km", W)
                if key not in self._mesh_fns:
                    self._mesh_fns[key] = self._mesh_mod.make_sharded_kmer_matches(
                        self.mesh, self.k, W, self.bits.shape[1] * 32,
                        W - self.k + 1, dparams=self.dparams,
                    )
                codes2, bad = self._mesh_mod.place_packed(self.mesh, codes2, bad)
                hitw, scores, ovf = self._mesh_fns[key](
                    self.table, self.bits, codes2, bad
                )
                return hitw, scores[:, :C], ovf
            return _prefetch(query_kmer_matches_packed2(
                self.table, self.bits, codes2, bad,
                k=self.k, width=W, num_colors=C,
                dparams=self.dparams, color_runs=self._color_runs(W),
                probe_budget=self._pb,
            ))

        def consume(qid0, n, lens, names, handle, chunk):
            nonlocal num_redo
            hitw = np.ascontiguousarray(np.asarray(handle[0][:n]))
            # keep the device's count dtype (u16): format_km has a direct
            # u16 path, skipping a (batch, C) int64 conversion
            counts = np.asarray(handle[1][:n])
            ovf_any = np.asarray(handle[2][:n])
            widths = np.maximum(0, lens.astype(np.int64) - self.k + 1)
            Wcap = hitw.shape[1] * 32
            bad = np.flatnonzero((widths > Wcap) | ovf_any)
            num_redo += len(bad)
            exact = {}
            if len(bad):
                for j, c in zip(bad, self._redo_csids_inline(
                        qid0, chunk, lens, bad, query_path)):
                    exact[int(j)] = c
            seg_start = 0
            for j in list(bad) + [n]:
                kj = np.arange(seg_start, j)
                if len(kj):
                    f.write(native.format_km(
                        [names[jj] for jj in kj],
                        hitw[kj],
                        widths[kj].astype(np.int32),
                        counts[kj],
                    ))
                if j < n:
                    c = exact[int(j)]
                    write_one(names[j], c != INVALID_U32, c)
                seg_start = j + 1

        total, _long_ids, _psec, _own = self._stream(
            query_path, dispatch, consume, need_names=True, progress=verbose)
        f.close()
        return dict(num_reads=total, num_redo=num_redo)


def conservation_runs(hit: np.ndarray, csid: np.ndarray):
    """Maximal runs of consecutive positive windows with equal color-set id
    (reference src/kmer_conservation.cpp:6-54). -> [(start, len, csid)]."""
    triples = []
    cur_start, cur_len, cur_id = 0, 0, None
    for i in range(len(hit)):
        if hit[i]:
            sid = int(csid[i])
            if cur_id != sid:
                if cur_id is not None:
                    triples.append((cur_start, cur_len, cur_id))
                cur_start, cur_len, cur_id = i, 0, sid
            cur_len += 1
        else:
            if cur_id is not None:
                triples.append((cur_start, cur_len, cur_id))
            cur_id = None
    if cur_id is not None:
        triples.append((cur_start, cur_len, cur_id))
    return triples
