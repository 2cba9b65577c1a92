"""Jitted end-to-end query steps (single device). Multi-device versions
with mesh sharding live in fulgor_tpu/parallel/mesh.py.

All steps are exact for every read — no dedup budget, no overflow fallback
(see ops/intersect.py). The color-algebra strategy is chosen statically by
the number of distinct color sets S:

    S <= ONEHOT_MAX_SETS  : comparison-reduce + one matmul (zero gathers)
    otherwise             : one bit-row gather per window + AND/matmul
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

# Read ONCE at import: jit caches are keyed by shapes/static args, not env
# vars, so a mid-process toggle would silently keep the first-traced kernel
# (ADVICE round 2). Set FULGOR_ANCHORED_PROBE=1 before importing to A/B.
ANCHORED_PROBE = os.environ.get("FULGOR_ANCHORED_PROBE", "0") == "1"

from .intersect import (
    ONEHOT_MAX_SETS,
    compact_runs,
    compact_runs_starts,
    first_set_bits,
    pack_bool_bits,
    full_intersection_onehot,
    full_intersection_runs,
    full_intersection_windows,
    threshold_union_scores_onehot,
    threshold_union_scores_runs,
    threshold_union_scores_windows,
)
from .lookup import lookup_batch, unpack_reads

# Color-stage strategy: adjacent equal-csid windows collapse into runs
# (scatter-free popcount compaction) and color rows are gathered per RUN —
# but ONLY when the index has the streaming locality to compact (clonal
# pangenomes: the reference's real Salmonella workload averages 23
# kmers/unitig ~ 6 runs/150bp read). On SNP-shredded graphs (union of
# variants breaks unitigs every 1-2 k-mers) csid changes nearly every
# window, runs don't compact, and the per-window gather is the right
# call. The ENGINE decides per index from num_kmers/num_unitigs and
# threads `color_runs` (a static run budget, or None for per-window)
# through the query steps; reads whose run count exceeds the budget set
# ovf and take the exact host redo.


def color_runs_budget(Wk: int, ekpu: float) -> int | None:
    """Static run budget for the color stage, or None -> per-window.

    ekpu = READ-WEIGHTED expected kmers/unitig (Index.expected_kmers_per
    _unitig: unitig length weighted by occurrence count — a conserved
    1-kmer unitig shared by 1000 genomes is traversed 1000x more often
    than a private one of equal text share, so the text-average
    num_kmers/num_unitigs mispredicts badly: pan1k text-avg 13.9 vs
    read-weighted 4.9). The 3x factor absorbs entry-position and
    miss-break effects.

    Low-locality note (pan1k): forcing a mid run budget (R=32) at
    ekpu < 8 did NOT help end-to-end — the run compaction itself cost
    about as much as the row gathers it saved, lost in the
    probe-dominated total. Per-window stays the
    low-locality default; the ENGINE additionally de-escalates any
    mispredicted runs budget to per-window when a batch overflows en
    masse (QueryEngine._cr_off)."""
    if ekpu < 8.0:
        return None
    R = -(-int(3.0 * Wk / ekpu) // 8) * 8 + 16
    return None if R >= Wk // 2 else min(Wk, R)


def dict_probe(table, codes, k: int, dparams, probe_budget=None):
    """Backend-dispatched window lookup -> (hit, csid, ovf).

    table: cuckoo (nb, 4) array when dparams is None, else the minidict2
    (slots, text32, sec_table) tuple with dparams = (m, num_slots) static.
    ovf marks windows the mini probe could not decide (VERIFY_BUDGET
    exhausted); callers reduce it per read for the host's exact fallback.
    The cuckoo backend never overflows."""
    if dparams is None:
        hit, csid = lookup_batch(table, codes, k)
        return hit, csid, jnp.zeros_like(hit)
    from .minidict2 import lookup_minidict2_batch, lookup_minidict2_batch_anchored

    m, num_slots = dparams
    slots, text32, sec = table
    # Run-anchored probing (DESIGN-NOTES §9b) is OPT-IN: it lost its
    # end-to-end A/B against the per-window probe (DESIGN-NOTES §17).
    # ANCHORED_PROBE is read once at import so the traced kernel cannot
    # silently diverge from the knob.
    if ANCHORED_PROBE:
        return lookup_minidict2_batch_anchored(
            slots, text32, sec, codes, k=k, m=m, num_slots=num_slots
        )
    return lookup_minidict2_batch(
        slots, text32, sec, codes, k=k, m=m, num_slots=num_slots,
        probe_budget=probe_budget,
    )


def dict_probe_packed(table, codes2, bad, width: int, k: int, dparams,
                      probe_budget=None):
    """dict_probe for host-packed (codes2, bad) stream buffers: the mini
    backend's prep consumes the packed words directly (no device unpack);
    the cuckoo backend unpacks as before.

    probe_budget: None -> one-pass at the default budgets; a 2-tuple
    (vb, sc) -> one-pass trimmed; a 4-tuple (vb1, vb2, sc, RU) -> the
    STAGED probe (minidict2.lookup_minidict2_staged_packed: vb1 verifies
    on every lane + compacted full-budget second pass) — the engine picks
    it on skew-light dictionaries."""
    if dparams is None:
        codes = unpack_reads(codes2, bad, width)
        hit, csid = lookup_batch(table, codes, k)
        return hit, csid, jnp.zeros_like(hit)
    from .minidict2 import (
        lookup_minidict2_anchored_packed,
        lookup_minidict2_packed,
        lookup_minidict2_staged_packed,
    )

    m, num_slots = dparams
    slots, text32, sec = table
    if ANCHORED_PROBE:
        return lookup_minidict2_anchored_packed(
            slots, text32, sec, codes2, bad, width=width, k=k, m=m,
            num_slots=num_slots
        )
    if probe_budget is not None and len(probe_budget) == 4:
        vb1, vb2, sc, ru = probe_budget
        return lookup_minidict2_staged_packed(
            slots, text32, sec, codes2, bad, width=width, k=k, m=m,
            num_slots=num_slots, vb1=vb1, vb2=vb2, sc=sc, RU=ru,
        )
    return lookup_minidict2_packed(
        slots, text32, sec, codes2, bad, width=width, k=k, m=m,
        num_slots=num_slots, probe_budget=probe_budget,
    )


def _fi_dispatch(dense_bits, hit, csid, color_runs=None):
    """-> (result bits (B, C32) u32, run-budget ovf (B,) bool)."""
    S, C32 = dense_bits.shape
    B, W = hit.shape
    if S <= ONEHOT_MAX_SETS:
        return (full_intersection_onehot(dense_bits, hit, csid),
                jnp.zeros((B,), bool))
    if color_runs is None:
        return (full_intersection_windows(dense_bits, hit, csid),
                jnp.zeros((B,), bool))
    run_csid, _cnt, rovf = compact_runs(hit, csid, color_runs)
    return (full_intersection_runs(dense_bits, run_csid, jnp.any(hit, axis=1)),
            rovf)


def _tu_dispatch(dense_bits, hit, csid, num_colors, color_runs=None):
    """-> (scores (B, C) f32, run-budget ovf (B,) bool)."""
    S, C32 = dense_bits.shape
    B, W = hit.shape
    if S <= ONEHOT_MAX_SETS:
        return (threshold_union_scores_onehot(dense_bits, hit, csid, num_colors),
                jnp.zeros((B,), bool))
    if color_runs is None:
        return (threshold_union_scores_windows(dense_bits, hit, csid,
                                               num_colors),
                jnp.zeros((B,), bool))
    run_csid, run_cnt, rovf = compact_runs(hit, csid, color_runs)
    return (threshold_union_scores_runs(dense_bits, run_csid, run_cnt,
                                        num_colors), rovf)


@partial(jax.jit, static_argnames=("k", "dparams", "color_runs", "probe_budget"))
def query_full_intersection(table, dense_bits, codes, *, k: int, dparams=None,
                            color_runs=None, probe_budget=None):
    """codes: (B, L) int32 -> (result_bits (B, C32) u32, ovf (B,) bool). A
    read maps iff its result is non-empty (reference counts mapped reads the
    same way, tools/pseudoalign.cpp:42); ovf reads need the host fallback."""
    hit, csid, ovf = dict_probe(table, codes, k, dparams, probe_budget)
    bits, rovf = _fi_dispatch(dense_bits, hit, csid, color_runs)
    return bits, jnp.any(ovf, axis=1) | rovf


@partial(jax.jit, static_argnames=("k", "num_colors", "dparams", "color_runs", "probe_budget"))
def query_threshold_union(table, dense_bits, codes, *, k: int, num_colors: int,
                          dparams=None, color_runs=None, probe_budget=None):
    """-> (scores (B, C) f32, num_positive (B,) i32, ovf (B,) bool)."""
    hit, csid, ovf = dict_probe(table, codes, k, dparams, probe_budget)
    scores, rovf = _tu_dispatch(dense_bits, hit, csid, num_colors, color_runs)
    npos = jnp.sum(hit.astype(jnp.int32), axis=1)
    return scores, npos, jnp.any(ovf, axis=1) | rovf


@partial(jax.jit, static_argnames=("k", "dparams", "probe_budget"))
def query_window_csids(table, codes, *, k: int, dparams=None,
                       probe_budget=None):
    """Per-window positivity + color-set id (kmer-conservation / kmer-matches
    drivers post-process on host). -> (hit, csid, ovf) each (B, W)."""
    return dict_probe(table, codes, k, dparams)


@partial(jax.jit, static_argnames=("k", "width", "dparams", "color_runs", "probe_budget"))
def query_full_intersection_packed(table, dense_bits, codes2, bad, *, k: int,
                                   width: int, dparams=None, color_runs=None,
                                   probe_budget=None):
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    bits, rovf = _fi_dispatch(dense_bits, hit, csid, color_runs)
    return bits, jnp.any(ovf, axis=1) | rovf


@partial(jax.jit, static_argnames=("k", "width", "num_colors", "dparams",
                                   "color_runs", "probe_budget"))
def query_threshold_union_packed(
    table, dense_bits, codes2, bad, *, k: int, width: int, num_colors: int,
    dparams=None, color_runs=None, probe_budget=None
):
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    scores, rovf = _tu_dispatch(dense_bits, hit, csid, num_colors, color_runs)
    npos = jnp.sum(hit.astype(jnp.int32), axis=1)
    # scores are exact window counts < 2^16 (stream reads are <= 1024 bases;
    # longer reads take the host path) — narrow the fetch
    return (scores.astype(jnp.uint16), npos.astype(jnp.int32),
            jnp.any(ovf, axis=1) | rovf)


@partial(jax.jit, static_argnames=("k", "width", "dparams", "probe_budget"))
def query_window_csids_packed(table, codes2, bad, *, k: int, width: int,
                              dparams=None, probe_budget=None):
    return dict_probe_packed(table, codes2, bad, width, k, dparams,
                             probe_budget)


# ---------------------------------------------------------------------------
# Compacted-fetch steps: with many colors the (B, C)-shaped result fetch
# grows with C (at C=4,546 the FI row fetch is ~18 MB per 32k batch). These
# variants
# compact the result ON DEVICE to <=T color ids per read (+ the full row
# kept on device for the rare over-T reads, fetched selectively), and ship
# kmer-conservation as (start, len, csid) runs instead of per-window csids.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "width", "T", "dparams", "color_runs", "probe_budget"))
def query_fi_lists_packed(table, dense_bits, codes2, bad, *, k: int, width: int,
                          T: int, dparams=None, color_runs=None,
                          probe_budget=None):
    """Full intersection with device-side list compaction.

    -> (count (B,) i32, lists (B, T) i32 ascending, bits (B, C32) u32 —
       fetch rows only for reads with count > T, ovf (B,) bool)."""
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    bits, rovf = _fi_dispatch(dense_bits, hit, csid, color_runs)
    count, lists = first_set_bits(bits, T)
    return count, lists, bits, jnp.any(ovf, axis=1) | rovf


@partial(jax.jit, static_argnames=("k", "width", "num_colors", "T", "dparams",
                                   "color_runs", "probe_budget"))
def query_tu_lists_packed(table, dense_bits, codes2, bad, minscore_tab, *,
                          k: int, width: int, num_colors: int, T: int,
                          dparams=None, color_runs=None, probe_budget=None):
    """Threshold union with the >= min_score comparison moved on device.

    minscore_tab: (W+1,) i32 = floor(npos * tau) per possible positive count
    (host-computed in f64 so device f32 rounding can never diverge from the
    reference rule, src/ps_threshold_union.cpp:389).
    -> (count (B,) i32, lists (B, T) i32, maskbits (B, C32) u32, ovf)."""
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    scores, rovf = _tu_dispatch(dense_bits, hit, csid, num_colors, color_runs)
    npos = jnp.sum(hit.astype(jnp.int32), axis=1)
    ms = jnp.take(minscore_tab, npos, axis=0)
    mask = (scores >= ms[:, None].astype(scores.dtype)) & (npos > 0)[:, None]
    pad = (-num_colors) % 32
    if pad:
        mask = jnp.pad(mask, ((0, 0), (0, pad)))
    maskbits = pack_bool_bits(mask)
    count, lists = first_set_bits(maskbits, T)
    return count, lists, maskbits, jnp.any(ovf, axis=1) | rovf


@partial(jax.jit, static_argnames=("k", "width", "R", "dparams", "probe_budget"))
def query_conservation_runs_packed(table, codes2, bad, *, k: int, width: int,
                                   R: int, dparams=None, probe_budget=None):
    """kmer-conservation with device-side run extraction: the fetch is R
    (csid, start, len) records per read instead of W csids.

    -> (run_csid (B,R) u32, run_start (B,R) u16, run_len (B,R) u16,
        ovf (B,) bool — run budget exceeded or probe overflow)."""
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    run_csid, run_start, run_len, rovf = compact_runs_starts(hit, csid, R)
    return (
        run_csid,
        run_start.astype(jnp.uint16),
        run_len.astype(jnp.uint16),
        rovf | jnp.any(ovf, axis=1),
    )


@partial(jax.jit, static_argnames=("k", "width", "R", "dparams", "probe_budget"))
def query_runs_tu_packed(table, codes2, bad, *, k: int, width: int,
                         R: int, dparams=None, probe_budget=None):
    """Threshold-union fetch WITHOUT any device color data (the 150k-color
    regime: no dense matrix exists anywhere): ship per-read (csid, count)
    runs + the positive-window count; the host scores against on-demand
    decoded sets (reference merge semantics, src/ps_threshold_union.cpp:
    320-387). -> (run_csid (B,R) u32, run_cnt (B,R) i32, npos (B,) i32,
    ovf (B,) bool)."""
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    run_csid, run_cnt, rovf = compact_runs(hit, csid, R)
    npos = jnp.sum(hit.astype(jnp.int32), axis=1)
    return run_csid, run_cnt, npos, rovf | jnp.any(ovf, axis=1)


@partial(jax.jit, static_argnames=("k", "width", "R", "dparams", "probe_budget"))
def query_distinct_runs_packed(table, codes2, bad, *, k: int, width: int,
                               R: int, dparams=None, probe_budget=None):
    """Distinct-set fetch (FI runs path + --deduplicate): compacted
    (possibly duplicated) run csids per read; the host derives the
    distinct-set key from <=R entries instead of W window csids.

    The two overflow causes return SEPARATELY because their recoveries
    differ by ~1000x: run-budget overflow (>R distinct runs) means the
    probe DECIDED every window — the full per-window csid array (kept on
    device; INVALID where no hit) is exact and the host just gathers the
    few overflowed rows — while probe overflow needs a full-budget
    re-probe. -> (run_csid (B,R) u32, probe_ovf (B,) bool, run_ovf (B,)
    bool, csid (B,Wk) u32 device-resident)."""
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    run_csid, _cnt, rovf = compact_runs(hit, csid, R)
    return run_csid, jnp.any(ovf, axis=1), rovf, csid


def _pack_hits(hit):
    W = hit.shape[1]
    pad = (-W) % 32
    if pad:
        hit = jnp.pad(hit, ((0, 0), (0, pad)))
    return pack_bool_bits(hit)


@partial(jax.jit, static_argnames=("k", "width", "small_csid", "dparams", "probe_budget"))
def query_conservation_packed(table, codes2, bad, *, k, width, small_csid: bool,
                              dparams=None, probe_budget=None):
    """kmer-conservation device step: positivity packed to bit words and
    csid narrowed to u16 when the set count allows — the device->host
    copy is a pipeline stage."""
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    hitw = _pack_hits(hit)
    if small_csid:
        csid_out = jnp.where(hit, csid, jnp.uint32(0xFFFF)).astype(jnp.uint16)
    else:
        csid_out = csid
    return hitw, csid_out, jnp.any(ovf, axis=1)


@partial(jax.jit, static_argnames=("k", "width", "num_colors", "dparams",
                                   "color_runs", "probe_budget"))
def query_kmer_matches_packed2(table, dense_bits, codes2, bad, *, k, width,
                               num_colors, dparams=None, color_runs=None,
                               probe_budget=None):
    """kmer-matches with bit-packed positivity (fetch-size optimized)."""
    hit, csid, ovf = dict_probe_packed(table, codes2, bad, width, k, dparams, probe_budget)
    scores, rovf = _tu_dispatch(dense_bits, hit, csid, num_colors, color_runs)
    return (_pack_hits(hit), scores.astype(jnp.uint16),
            jnp.any(ovf, axis=1) | rovf)
