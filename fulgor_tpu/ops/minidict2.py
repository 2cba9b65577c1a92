"""Minimizer-positional k-mer dictionary, v2: bucketless robin-hood layout
with a skew pointer table for heavy minimizers.

v1 (ops/minidict.py) stores buckets as an explicit (start, count) array —
8-16 B/entry of pure metadata — and probes up to `cap` candidates with two
text extracts each. v2 removes the bucket array entirely:

  * slot array of M = ceil(NE / LOAD) entry slots, 12 B each, packed ROWW
    to a row (one probe = SCAN/ROWW row gathers covering SCAN slots);
    bucket = fastrange(h, M) (monotone in h, arbitrary M — no power-of-two
    waste);
  * entries sorted by bucket and placed greedily at the first free slot at
    or after their bucket; a minimizer group that cannot fit entirely
    inside the probe's SCAN-slot window is PARKED in arbitrary free slots
    (covered bit set) and reached through the skew table instead;
  * each entry carries a 15-bit fingerprint of the minimizer hash plus a
    STRAND bit (is the text m-mer at the stored minimizer position the
    canonical form?), so the probe screens SCAN slots with pure register
    compares, resolves candidate orientation WITHOUT trying both (odd m:
    no palindromic m-mers, so strand mismatch proves the text compare
    would fail), and text-verifies only the (typically 0-1)
    fingerprint+strand+in-span survivors;
  * heavy minimizer groups (>= COVER_GROUP entries — pangenomes of many
    near-identical genomes produce thousands of these) get one SKEW TABLE
    slot per COVERED K-MER: a u32 (fp8 | primary_slot_id+1) pointer keyed
    by the canonical k-mer, 2-choice rows of 8. The probe routes covered
    windows by full-k-mer hash straight to the right parked entry — the
    SSHash skew-index idea (reference sshash; see SURVEY §2.2) with
    pointers instead of an MPHF. ~4.7 B per covered k-mer vs ~19 B for the
    previous per-k-mer exact table.

Space: 12 B/LOAD per entry + 0.5 B/base text + ~4.7 B per covered k-mer;
at (k=31, m=19) one entry covers ~5-6.5 k-mers => ~3-6 B/k-mer total
(corpus-dependent) vs 19.5 for the cuckoo table and ~1 for SSHash
(reference include/index.hpp:13).

Exactness contract (device + host agree):
  hit  => the k-mer IS in the index and csid is its color-set id
          (always a text-verified 62-bit compare);
  ovf  => the probe ran out of verify/candidate slots before deciding; the
          caller must fall back to the exact host probe (rare: fp8/fp16
          collision pileups, measured well below 0.1% of windows).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import INVALID_U32
from ..core import kmers as K
from .minidict import (
    SEED_M,
    _mix32_np,
    mmer_hashes,
    sliding_min_argmin,
    window_packings_lsb,
)

LOAD = 0.6
SCAN = 8  # slots screened per probe
ROWW = 8  # entries per slot row (power of 2): SCAN/ROWW row gathers per probe
VERIFY_BUDGET = 6  # text verifications per probe (shared across orientations)
COVER_GROUP = 4  # groups with >= this many entries route via the skew table
MAX_SPAN = 127  # span field is 7 bits (bit 15 of the meta word = covered)

# skew table: per-covered-k-mer u32 pointer (fp8 | slot_id+1), keyed by the
# LSB-first canonical packing (min of fwd/rc as (hi, lo) tuples — no
# bit-reversal needed on device). 2-choice rows of SKEW_ROWW slots; probe =
# 2 mix32 hashes + 2 row gathers + <=SKEW_CAND entry gathers + text verify.
SKEW_SEED1 = 0x2545F491
SKEW_SEED2 = 0x9E3779B9
SKEW_LOAD = 0.85
SKEW_ROWW = 8  # u32 slots per row: one 32 B gather
SKEW_CAND = 3  # fp8-matching entries chased per probe (more -> ovf)


def _skew_hash_np(klo, khi, seed):
    return _mix32_np(klo ^ _mix32_np(khi ^ np.uint32(seed)))


def _fastrange_np(h, n):
    return ((h.astype(np.uint64) * np.uint64(n)) >> np.uint64(32)).astype(np.int64)


def canonical_lsb_np(flo, fhi, rlo, rhi):
    take_f = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    return np.where(take_f, flo, rlo), np.where(take_f, fhi, rhi)


def skew_build(klo: np.ndarray, khi: np.ndarray, slot_ids: np.ndarray) -> np.ndarray:
    """Build the (NR, SKEW_ROWW) uint32 pointer table: slot value =
    ((primary_slot_id + 1) << 8) | fp8, 0 = empty. Greedy 2-choice row
    placement (each key targets the emptier of its two rows, round by
    round; the table grows until every key fits — bins of 8 at load 0.85
    virtually always succeed). Keys must be distinct."""
    n = len(slot_ids)
    if n == 0:
        return np.zeros((1, SKEW_ROWW), dtype=np.uint32)
    assert int(slot_ids.max()) + 1 < (1 << 24), (
        "primary slot id exceeds the 24-bit skew pointer; widen the skew "
        "slot layout for indexes beyond ~16M dictionary entries"
    )
    klo = klo.astype(np.uint32)
    khi = khi.astype(np.uint32)
    h1 = _skew_hash_np(klo, khi, SKEW_SEED1)
    h2 = _skew_hash_np(klo, khi, SKEW_SEED2)
    val = ((slot_ids.astype(np.uint32) + np.uint32(1)) << np.uint32(8)) | (
        h1 & np.uint32(0xFF)
    )
    NR = max(2, int(np.ceil(n / SKEW_ROWW / SKEW_LOAD)))
    while True:
        r1 = _fastrange_np(h1, NR)
        r2 = _fastrange_np(h2, NR)
        counts = np.zeros(NR, dtype=np.int32)
        row_of = np.full(n, -1, dtype=np.int64)
        pending = np.arange(n, dtype=np.int64)
        # phase 1: vectorized greedy rounds (emptier of the two rows) —
        # places ~96% of keys at load 0.85; no eviction
        for _round in range(32):
            if not len(pending):
                break
            tgt = np.where(
                counts[r1[pending]] <= counts[r2[pending]], r1[pending], r2[pending]
            )
            order = np.argsort(tgt, kind="stable")
            ts = tgt[order]
            new = np.concatenate([[True], ts[1:] != ts[:-1]])
            starts = np.flatnonzero(new)
            glen = np.diff(np.concatenate([starts, [len(ts)]]))
            rank = np.arange(len(ts)) - np.repeat(starts, glen)
            ok = rank < (SKEW_ROWW - counts[ts])
            row_of[pending[order[ok]]] = ts[ok]
            np.add.at(counts, ts[ok], 1)
            pending = pending[order[~ok]]
            if not ok.any():
                break
        # phase 2: sequential cuckoo eviction for the stragglers whose rows
        # both filled (the tail the greedy phase cannot place)
        occ = np.full(NR * SKEW_ROWW, -1, dtype=np.int64)  # slot -> key
        placed_keys = np.flatnonzero(row_of >= 0)
        pr = row_of[placed_keys]
        order = np.argsort(pr, kind="stable")
        ro = pr[order]
        new = np.concatenate([[True], ro[1:] != ro[:-1]])
        starts = np.flatnonzero(new)
        glen = np.diff(np.concatenate([starts, [len(ro)]]))
        slotpos = np.arange(len(ro)) - np.repeat(starts, glen)
        occ[ro * SKEW_ROWW + slotpos] = placed_keys[order]
        ok_all = True
        for key in pending:
            key = int(key)
            steps = 0
            while True:
                placed = False
                for rr in (int(r1[key]), int(r2[key])):
                    base = rr * SKEW_ROWW
                    for e in range(SKEW_ROWW):
                        if occ[base + e] < 0:
                            occ[base + e] = key
                            placed = True
                            break
                    if placed:
                        break
                if placed:
                    break
                steps += 1
                if steps > 5000:
                    ok_all = False
                    break
                # evict a pseudo-random victim from the first-choice row and
                # take its slot; the victim re-inserts (deterministic walk)
                rr = int(r1[key]) if steps % 2 else int(r2[key])
                e = ((int(h1[key]) ^ (steps * 0x9E3779B9)) >> 7) % SKEW_ROWW
                v = rr * SKEW_ROWW + e
                victim = int(occ[v])
                occ[v] = key
                key = victim
            if not ok_all:
                break
        if ok_all:
            break
        NR = int(NR * 1.2) + 1
    rows = np.zeros((NR, SKEW_ROWW), dtype=np.uint32)
    filled = np.flatnonzero(occ >= 0)
    rows.reshape(-1)[filled] = val[occ[filled]]
    return rows


def upgrade_slots_v2_to_v3(slots: np.ndarray, text32: np.ndarray,
                           m: int) -> np.ndarray:
    """Upgrade a v2 slot array (16-bit fingerprints) to the v3 strand-bit
    layout: the low 15 fingerprint bits are IDENTICAL in both formats
    (fp = key & 0x7FFF), so only bit 31 changes — recomputed as the entry's
    text-strand bit (is the m-mer at wlo+moff canonical?) from the
    dictionary's own text. Tombstones/empty slots get bit 31 = 0."""
    flat = slots.reshape(-1, 3).copy()
    # reconstruct the base codes from the stride-32 overlapping text rows
    words = np.empty(2 * len(text32) + 2, dtype=np.uint32)
    words[: 2 * len(text32) : 2] = text32[:, 0]
    words[1 : 2 * len(text32) : 2] = text32[:, 1]
    words[-2:] = text32[-1, 2:4]
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    codes = ((words[:, None] >> shifts) & np.uint32(3)).astype(np.uint8).ravel()
    km, _v = K.pack_kmers(codes, m)
    # match the build path's tf init (_minimizer_runs: np.ones) so an
    # upgraded index is bit-identical to a fresh v3 build
    tf = np.ones(len(codes), dtype=bool)
    if len(km):
        tf[: len(km)] = km <= K.revcomp_packed(km, m)
    ms = flat[:, 2]
    sp = (ms >> np.uint32(8)) & np.uint32(0x7F)
    real = sp > 0
    mpos = (flat[:, 0] + (ms & np.uint32(0xFF))).astype(np.int64)
    assert not real.any() or (
        int(mpos[real].max()) + m <= len(tf) and int(mpos[real].min()) >= 0
    ), "v2 slot entry minimizer position outside dictionary text (corrupt index)"
    sigma = np.zeros(len(flat), dtype=np.uint32)
    sigma[real] = tf[mpos[real]]
    flat[:, 2] = (ms & np.uint32(0x7FFFFFFF)) | (sigma << np.uint32(31))
    return flat.reshape(slots.shape)


def skew_candidates_host(skew: np.ndarray, klo: np.ndarray, khi: np.ndarray):
    """All fp8-matching (key_index, primary_slot_id) pairs in probe order
    (row1 slots, then row2 slots), plus the per-key match count. Exact host
    paths verify every pair; device-semantics paths cap at SKEW_CAND."""
    NR = len(skew)
    h1 = _skew_hash_np(klo, khi, SKEW_SEED1)
    h2 = _skew_hash_np(klo, khi, SKEW_SEED2)
    fp = h1 & np.uint32(0xFF)
    cnt = np.zeros(len(klo), dtype=np.int32)
    pairs_i: list[np.ndarray] = []
    pairs_s: list[np.ndarray] = []
    for r in (_fastrange_np(h1, NR), _fastrange_np(h2, NR)):
        row = skew[r]
        for e in range(SKEW_ROWW):
            v = row[:, e]
            m = (v != 0) & ((v & np.uint32(0xFF)) == fp)
            sel = np.flatnonzero(m)
            pairs_i.append(sel)
            pairs_s.append((v[sel] >> np.uint32(8)).astype(np.int64) - 1)
            cnt += m.astype(np.int32)
    return cnt, pairs_i, pairs_s


def _fastrange32(h: np.ndarray, M: int) -> np.ndarray:
    return ((h.astype(np.uint64) * np.uint64(M)) >> np.uint64(32)).astype(np.int64)


def probe_key(h: np.ndarray) -> np.ndarray:
    """Minimizer hashes are sliding MINIMA — strongly biased low — so they
    must be re-mixed before fastrange bucketing (and fp extraction)."""
    return _mix32_np(h)


@dataclass
class MiniDict2:
    k: int
    m: int
    slots: np.ndarray  # (MR, 3*ROWW) uint32: ROWW 12 B entries per row
    num_slots: int  # M (fastrange modulus)
    text32: np.ndarray  # (n, 4) uint32: 64 bases per row, stride 32
    sec_table: np.ndarray  # (NR, SKEW_ROWW) u32 skew pointers (fp8|slot+1)
    spill_frac: float  # fraction of k-mers routed via the skew table
    multi_tail: float  # fraction of probe sites with >VERIFY_SLOTS in-span cands

    def num_bytes(self) -> int:
        return int(self.slots.nbytes + self.text32.nbytes + self.sec_table.nbytes)


def text32_from_packed(seq_u64: np.ndarray, total_bases: int) -> np.ndarray:
    """Derive the (n, 4) uint32 text rows from 2-bit packed uint64 words
    (core.kmers.pack2 layout = LSB-first, little-endian), without unpacking
    to bases. Identical to pack_text32(unpack2(seq_u64, total_bases))."""
    w32 = np.asarray(seq_u64, dtype="<u8").view(np.uint32)
    n = int(total_bases)
    nwords = (n + 15) // 16 + 4
    assert len(w32) * 16 >= n, "packed text shorter than total_bases"
    if len(w32) < nwords:
        w32 = np.concatenate([w32, np.zeros(nwords - len(w32), np.uint32)])
    n32 = (nwords - 3) // 2
    return np.stack(
        [w32[0 : 2 * n32 : 2], w32[1 : 2 * n32 + 1 : 2],
         w32[2 : 2 * n32 + 2 : 2], w32[3 : 2 * n32 + 3 : 2]],
        axis=1,
    )


def pack_text32(codes: np.ndarray) -> np.ndarray:
    """Base codes -> (n, 4) uint32 rows covering 64 bases each at 32-base
    stride (LSB-first, 16 bases/word). One 16 B gather yields >=33
    contiguous bases from any position."""
    n = len(codes)
    nwords = (n + 15) // 16 + 4
    c = np.concatenate([codes & 3, np.zeros(nwords * 16 - n, dtype=np.uint8)]).astype(
        np.uint32
    ).reshape(-1, 16)
    words = np.zeros(len(c), dtype=np.uint32)
    for i in range(16):
        words |= c[:, i] << np.uint32(2 * i)
    n32 = (len(words) - 3) // 2
    return np.stack(
        [words[0 : 2 * n32 : 2], words[1 : 2 * n32 + 1 : 2],
         words[2 : 2 * n32 + 2 : 2], words[3 : 2 * n32 + 3 : 2]],
        axis=1,
    )


def extract33_host(text32: np.ndarray, q) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) u32 = 32 bases LSB-first at base position q (vectorized)."""
    q = np.asarray(q, dtype=np.int64)
    row = text32[np.clip(q >> 5, 0, len(text32) - 1)]
    sh = (2 * (q & 31)).astype(np.uint32)
    big = sh >= 32
    s = np.where(big, sh - 32, sh)
    a0 = np.where(big, row[..., 1], row[..., 0])
    a1 = np.where(big, row[..., 2], row[..., 1])
    a2 = np.where(big, row[..., 3], row[..., 2])
    nz = s > 0
    inv = np.where(nz, np.uint32(32) - s, np.uint32(1))
    lo = np.where(nz, (a0 >> s) | (a1 << inv), a0)
    hi = np.where(nz, (a1 >> s) | (a2 << inv), a1)
    return lo.astype(np.uint32), hi.astype(np.uint32)


def _minimizer_runs(unitig_codes, unitig_offs, unitig_cs, k, m):
    """Maximal runs of k-mer positions with constant leftmost-minimizer
    position (split at 255). -> dict of per-entry arrays + per-position
    hash array (same construction as minidict.build_minidict)."""
    codes = np.asarray(unitig_codes, dtype=np.uint8)
    offs = np.asarray(unitig_offs, dtype=np.int64)
    ucs = np.asarray(unitig_cs, dtype=np.uint32)
    total = int(offs[-1])

    h = np.full(total, 0xFFFFFFFF, dtype=np.uint32)
    hm = mmer_hashes(codes, m)
    h[: len(hm)] = hm
    pos = np.arange(len(hm), dtype=np.int64)
    uid_m = np.searchsorted(offs, pos, side="right") - 1
    cross = (pos + m) > offs[uid_m + 1]
    h[: len(hm)][cross] = np.uint32(0xFFFFFFFF)

    w = k - m + 1
    minval, left, _right = sliding_min_argmin(h, w)
    nkpos = len(minval)
    kpos = np.arange(nkpos, dtype=np.int64)
    uid_k = np.searchsorted(offs, kpos, side="right") - 1
    valid_k = (kpos + k) <= offs[uid_k + 1]

    j = kpos + left
    prev_j = np.concatenate([[-2], j[:-1]])
    prev_valid = np.concatenate([[False], valid_k[:-1]])
    is_new = valid_k & (~prev_valid | (j != prev_j))
    starts = np.flatnonzero(is_new)
    run_id = np.cumsum(is_new) - 1
    counts = np.bincount(run_id[valid_k], minlength=len(starts))

    # split runs at MAX_SPAN (vectorized)
    n_sub = (counts + MAX_SPAN - 1) // MAX_SPAN
    sub_of_run = np.repeat(np.arange(len(starts)), n_sub)
    sub_idx = np.arange(int(n_sub.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(n_sub)])[:-1], n_sub
    )
    wlo = starts[sub_of_run] + MAX_SPAN * sub_idx
    span = np.minimum(counts[sub_of_run] - MAX_SPAN * sub_idx, MAX_SPAN)
    jj = j[starts][sub_of_run]
    moff = jj - wlo
    assert len(wlo) == 0 or ((moff >= 0).all() and (moff <= 255).all())
    # per-entry strand bit: is the TEXT m-mer at the stored minimizer
    # position the canonical form? (probe-side orientation filter)
    km, _mv = K.pack_kmers(codes, m)
    tf = np.ones(total, dtype=bool)
    if len(km):
        tf[: len(km)] = km <= K.revcomp_packed(km, m)
    return dict(
        wlo=wlo.astype(np.int64),
        span=span.astype(np.int64),
        moff=moff.astype(np.int64),
        csid=ucs[uid_k[starts]][sub_of_run],
        hash=h[jj],
        sigma=tf[jj],
        codes=codes,
    )


def build_minidict2(unitig_codes, unitig_offs, unitig_cs, k, m,
                    verbose=False) -> MiniDict2:
    assert m % 2 == 1, (
        "minidict2 requires odd m: the per-entry strand bit relies on "
        "m-mers never being their own reverse complement")
    r = _minimizer_runs(unitig_codes, unitig_offs, unitig_cs, k, m)
    NE = len(r["wlo"])
    M = max(16, int(np.ceil(NE / LOAD)))

    key = probe_key(r["hash"])
    bucket = _fastrange32(key, M)
    order = np.lexsort((r["wlo"], bucket))
    b_s = bucket[order]
    h_s = r["hash"][order]
    key_s = key[order]

    # group = maximal run of equal minimizer hash (consecutive after sort)
    g_new = np.concatenate([[True], h_s[1:] != h_s[:-1]])
    g_id = np.cumsum(g_new) - 1
    g_sizes = np.bincount(g_id)
    g_bucket = b_s[g_new]
    NG = len(g_sizes)

    # sequential first-fit placement: group i goes to the first free slot at
    # or after the row-aligned bucket; whole group spills if it cannot end
    # within [(b & ~(ROWW-1)), + SCAN). Exact greedy (the vectorized
    # fixpoint over-spills under cascades).
    placed = np.ones(NG, dtype=bool)
    start = np.zeros(NG, dtype=np.int64)
    lo_b = (g_bucket & ~np.int64(ROWW - 1))
    cur = 0
    for i in range(NG):
        s0 = max(cur, int(lo_b[i]))
        if s0 + int(g_sizes[i]) <= int(lo_b[i]) + SCAN:
            start[i] = s0
            cur = s0 + int(g_sizes[i])
        else:
            placed[i] = False

    # materialize slots; groups with >= COVER_GROUP entries are also pushed
    # to the secondary and their entries marked covered (bit 15), so the
    # probe can DECIDE windows whose candidate list exceeds the verify
    # budget (secondary miss proves absence for covered entries)
    M_pad = M + SCAN + ROWW
    MR = (M_pad + ROWW - 1) // ROWW + 2
    flat = np.zeros(MR * ROWW * 3, dtype=np.uint32).reshape(MR * ROWW, 3)
    ent_placed = np.repeat(placed, g_sizes)
    g_placed_sizes = np.where(placed, g_sizes, 0)
    within = np.arange(int(g_placed_sizes.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(g_placed_sizes)])[:-1][placed],
        g_sizes[placed],
    )
    slot_of = np.repeat(start[placed], g_sizes[placed]) + within
    sel = np.flatnonzero(ent_placed)
    covered_g = g_sizes >= COVER_GROUP
    ent_covered = np.repeat(covered_g, g_sizes)
    fp = (key_s & np.uint32(0x7FFF)).astype(np.uint32)
    wlo_s = r["wlo"][order]
    span_s = r["span"][order]
    moff_s = r["moff"][order]
    csid_s = r["csid"][order]
    sigma_s = r["sigma"][order]
    flat[slot_of, 0] = wlo_s[sel].astype(np.uint32)
    flat[slot_of, 1] = csid_s[sel]
    flat[slot_of, 2] = (
        moff_s[sel].astype(np.uint32)
        | (span_s[sel].astype(np.uint32) << np.uint32(8))
        | (ent_covered[sel].astype(np.uint32) << np.uint32(15))
        | (fp[sel] << np.uint32(16))
        | (sigma_s[sel].astype(np.uint32) << np.uint32(31))
    )

    # tombstones: every SPILLED group leaves a (sp=0, covered=1, fp) marker
    # in its probe window so the query can gate the skew gathers to the
    # (rare) windows that actually need them — all other windows gather row
    # 0, which coalesces to ~nothing on the memory system. If a window is
    # too full even for the marker, the probe's "window full" rule triggers
    # the skew path instead (see lookup_minidict2_batch).
    occupied = np.zeros(MR * ROWW, dtype=bool)
    occupied[slot_of] = True
    ts_g = np.flatnonzero(~placed)
    ts_fp = (key_s[g_new][ts_g] & np.uint32(0x7FFF)).astype(np.uint32)
    ts_lo = lo_b[ts_g]
    for i in range(len(ts_g)):
        base = int(ts_lo[i])
        for s in range(base, base + SCAN):
            if not occupied[s]:
                occupied[s] = True
                flat[s, 2] = (np.uint32(1) << np.uint32(15)) | (ts_fp[i] << np.uint32(16))
                break

    # park spilled entries in arbitrary free slots (covered bit set so the
    # window scan never treats them as candidates); they are reached only
    # through the skew table, by slot id
    unplaced_sel = np.flatnonzero(~ent_placed)
    free = np.flatnonzero(~occupied)
    if len(free) < len(unplaced_sel):  # pathological; grow the flat array
        extra = len(unplaced_sel) - len(free)
        flat = np.concatenate([flat, np.zeros((extra, 3), np.uint32)])
        free = np.concatenate([free, np.arange(len(occupied), len(flat))])
        MR = (len(flat) + ROWW - 1) // ROWW
        flat = np.concatenate(
            [flat, np.zeros((MR * ROWW - len(flat), 3), np.uint32)]
        )
    park = free[: len(unplaced_sel)]
    flat[park, 0] = wlo_s[unplaced_sel].astype(np.uint32)
    flat[park, 1] = csid_s[unplaced_sel]
    flat[park, 2] = (
        moff_s[unplaced_sel].astype(np.uint32)
        | (span_s[unplaced_sel].astype(np.uint32) << np.uint32(8))
        | (np.uint32(1) << np.uint32(15))
        | (fp[unplaced_sel] << np.uint32(16))
        | (sigma_s[unplaced_sel].astype(np.uint32) << np.uint32(31))
    )
    slots = flat.reshape(-1, 3 * ROWW)

    # skew table: one pointer per k-mer of covered (heavy-minimizer) or
    # parked entries, keyed by the canonical k-mer
    slot_all = np.empty(NE, dtype=np.int64)
    slot_all[ent_placed] = slot_of
    slot_all[~ent_placed] = park
    spill_sel = np.flatnonzero(~ent_placed | ent_covered)
    if len(spill_sel):
        sp_wlo = wlo_s[spill_sel]
        sp_span = span_s[spill_sel]
        sp_slot = slot_all[spill_sel]
        kpos = np.repeat(sp_wlo, sp_span) + (
            np.arange(int(sp_span.sum()))
            - np.repeat(np.concatenate([[0], np.cumsum(sp_span)])[:-1], sp_span)
        )
        kslot = np.repeat(sp_slot, sp_span)
        flo, fhi, rlo, rhi, _okw = window_packings_lsb(r["codes"], k)
        klo, khi = canonical_lsb_np(flo[kpos], fhi[kpos], rlo[kpos], rhi[kpos])
        key64 = (khi.astype(np.uint64) << np.uint64(32)) | klo.astype(np.uint64)
        _, uniq_idx = np.unique(key64, return_index=True)
        sec = skew_build(klo[uniq_idx], khi[uniq_idx], kslot[uniq_idx])
        n_spill_kmers = len(uniq_idx)
    else:
        sec = np.zeros((1, SKEW_ROWW), dtype=np.uint32)
        n_spill_kmers = 0

    nk = int(np.sum(r["span"]))
    spill_frac = n_spill_kmers / max(1, nk)
    d = MiniDict2(
        k=k, m=m, slots=slots, num_slots=M, text32=pack_text32(r["codes"]),
        sec_table=sec, spill_frac=spill_frac, multi_tail=-1.0,
    )
    if verbose:
        print(
            f"[minidict2] NE={NE} M={M} spilled entries="
            f"{len(spill_sel)} ({100 * len(spill_sel) / max(1, NE):.2f}%) "
            f"spilled kmers={n_spill_kmers} ({100 * spill_frac:.3f}%) "
            f"bytes={d.num_bytes() / 1e6:.1f}MB ({d.num_bytes() / max(1, nk):.2f} B/kmer)"
        )
    return d


# --------------------------------------------------------------------------
# host probes
# --------------------------------------------------------------------------


def _window_minimizers(codes: np.ndarray, k: int, m: int):
    h = mmer_hashes(codes, m)
    minval, left, right = sliding_min_argmin(h, k - m + 1)
    return minval, left, right


def _probe_candidates(d: MiniDict2, p, minval, left, right, tf=None):
    """In-slot-order (entry, orientation) candidates for window p:
    fingerprint-matching, in-span, NOT covered (covered entries are reached
    via the skew table). -> (cands [(q, csid, orient)], gated) where gated
    mirrors the device's need_sec rule (covered/marker fp match, or window
    full). Shared by both host probes.

    tf: per-position take_f (fwd m-mer == canonical) array — when given,
    candidates whose orientation is strand-incompatible with the entry's
    stored strand bit are dropped (the device-sem budget filter); the
    exact probe passes None and verifies both orientations."""
    k, m = d.k, d.m
    kk = probe_key(np.array([minval[p]], np.uint32))
    b = int(_fastrange32(kk, d.num_slots)[0])
    fp = np.uint32(int(kk[0]) & 0x7FFF)
    flat = d.slots.reshape(-1, 3)
    base = b & ~(ROWW - 1)
    cands = []
    gated = False
    n_occ = 0
    for sidx in range(base, base + SCAN):
        wlo, cs, ms = flat[sidx]
        sp = (int(ms) >> 8) & 0x7F
        cov = (int(ms) >> 15) & 1
        efp = np.uint32((int(ms) >> 16) & 0x7FFF)
        st = (int(ms) >> 31) & 1
        n_occ += int(sp > 0 or cov)
        if cov and efp == fp:
            gated = True
        if sp == 0 or efp != fp or cov:
            continue
        mo = int(ms) & 0xFF
        mpos = int(wlo) + mo
        qf = mpos - int(left[p])
        if int(wlo) <= qf < int(wlo) + sp and (
                tf is None or int(tf[p + int(left[p])]) == st):
            cands.append((qf, int(cs), 0))
        qr = mpos - (k - m) + int(right[p])
        if int(wlo) <= qr < int(wlo) + sp and (
                tf is None or int(tf[p + int(right[p])]) != st):
            cands.append((qr, int(cs), 1))
    if n_occ >= SCAN:
        gated = True
    return cands, gated


def _verify(d: MiniDict2, q, orient, flo, fhi, rlo, rhi, lo_mask, hi_mask):
    tlo, thi = extract33_host(d.text32, np.array([q]))
    if orient == 0:
        return (tlo[0] & lo_mask) == flo and (thi[0] & hi_mask) == fhi
    return (tlo[0] & lo_mask) == rlo and (thi[0] & hi_mask) == rhi


def _probe_read(d: MiniDict2, codes: np.ndarray, budget):
    """Shared host probe; budget=None -> exact (verify all candidates)."""
    k, m = d.k, d.m
    Wk = len(codes) - k + 1
    hit = np.zeros(max(0, Wk), dtype=bool)
    out = np.full(max(0, Wk), INVALID_U32, dtype=np.uint32)
    ovf = np.zeros(max(0, Wk), dtype=bool)
    if Wk <= 0:
        return hit, out, ovf
    minval, left, right = _window_minimizers(codes, k, m)
    flo, fhi, rlo, rhi, okw = window_packings_lsb(codes, k)
    km_m, _mv = K.pack_kmers(codes, m)
    tf = np.ones(len(codes), dtype=bool)
    if len(km_m):
        tf[: len(km_m)] = km_m <= K.revcomp_packed(km_m, m)
    lo_mask = np.uint32(0xFFFFFFFF) if 2 * k >= 32 else np.uint32((1 << (2 * k)) - 1)
    hi_mask = np.uint32((1 << (2 * k - 32)) - 1) if 2 * k > 32 else np.uint32(0)
    for p in range(Wk):
        if not okw[p] or minval[p] == 0xFFFFFFFF:
            continue
        cands, gated = _probe_candidates(
            d, p, minval, left, right, tf if budget is not None else None)
        nv = len(cands) if budget is None else min(budget, len(cands))
        for q, cs, orient in cands[:nv]:
            if _verify(d, q, orient, flo[p], fhi[p], rlo[p], rhi[p], lo_mask, hi_mask):
                hit[p], out[p] = True, cs
                break
        if not hit[p] and (gated or budget is None):
            # skew route (device gates it on need_sec; ungated windows can
            # never hold a skew key, so the exact path may probe freely)
            klo, khi = canonical_lsb_np(
                flo[p : p + 1], fhi[p : p + 1], rlo[p : p + 1], rhi[p : p + 1]
            )
            cnt2, pairs_i, pairs_s = skew_candidates_host(d.sec_table, klo, khi)
            sids = [int(s) for ps in pairs_s for s in ps]
            if budget is not None:
                sids = sids[:SKEW_CAND]
            flat = d.slots.reshape(-1, 3)
            tie = False
            for sid in sids:
                wlo, cs, ms = flat[sid]
                sp = (int(ms) >> 8) & 0x7F
                mo = int(ms) & 0xFF
                st = (int(ms) >> 31) & 1
                mpos = int(wlo) + mo
                qf = mpos - int(left[p])
                qr = mpos - (k - m) + int(right[p])
                if budget is None:
                    # exact: verify both orientations, no strand filter
                    for orient, q in ((0, qf), (1, qr)):
                        if (sp > 0 and int(wlo) <= q < int(wlo) + sp
                                and not hit[p]):
                            if _verify(d, q, orient, flo[p], fhi[p], rlo[p],
                                       rhi[p], lo_mask, hi_mask):
                                hit[p], out[p] = True, int(cs)
                    if hit[p]:
                        break
                    continue
                # device-sem mirror: strand filter + fused single verify
                # (fwd-derived candidate probed first; an unprobed viable
                # rc on the same candidate reports `tie` -> ovf)
                cand_f = (sp > 0 and int(wlo) <= qf < int(wlo) + sp
                          and int(tf[p + int(left[p])]) == st)
                cand_r = (sp > 0 and int(wlo) <= qr < int(wlo) + sp
                          and int(tf[p + int(right[p])]) != st)
                if not (cand_f or cand_r):
                    continue
                orient, q = (0, qf) if cand_f else (1, qr)
                if _verify(d, q, orient, flo[p], fhi[p], rlo[p], rhi[p],
                           lo_mask, hi_mask):
                    hit[p], out[p] = True, int(cs)
                    break
                if cand_f and cand_r:
                    tie = True
            if (not hit[p] and budget is not None and gated
                    and (int(cnt2[0]) > SKEW_CAND or tie)):
                ovf[p] = True
        if not hit[p] and budget is not None and len(cands) > budget:
            ovf[p] = True
    return hit, out, ovf


def lookup_host_exact(d: MiniDict2, codes: np.ndarray):
    """Exact per-window lookup for one read (unlimited verification; the
    overflow fallback and test oracle). -> (hit, csid)."""
    hit, out, _ = _probe_read(d, codes, budget=None)
    return hit, out


def lookup_host_device_sem(d: MiniDict2, codes: np.ndarray):
    """Host mirror of the DEVICE probe semantics (VERIFY_BUDGET shared
    verify slots): -> (hit, csid, ovf). Must agree with the device kernel
    bit-for-bit; tests compare both against lookup_host_exact."""
    return _probe_read(d, codes, budget=VERIFY_BUDGET)


def probe_windows_host(d: MiniDict2, codes: np.ndarray):
    """Vectorized EXACT lookup over every k-window of a 1-D code array
    (values > 3 invalid). Semantically equal to lookup_host_exact but
    numpy-batched over all windows — the bulk host path (check tooling,
    long-read/overflow fallbacks). -> (hit bool (Wk,), csid u32 (Wk,)).

    NOTE for concatenated multi-unitig text: windows crossing a boundary
    compute minimizers over the concatenation; the caller must mask them."""
    k, m = d.k, d.m
    codes = np.asarray(codes, dtype=np.uint8)
    Wk = len(codes) - k + 1
    hit = np.zeros(max(0, Wk), dtype=bool)
    out = np.full(max(0, Wk), INVALID_U32, dtype=np.uint32)
    if Wk <= 0:
        return hit, out
    minval, left, right = _window_minimizers(codes, k, m)
    flo, fhi, rlo, rhi, okw = window_packings_lsb(codes, k)
    usable = okw & (minval != np.uint32(0xFFFFFFFF))
    lo_mask = np.uint32(0xFFFFFFFF) if 2 * k >= 32 else np.uint32((1 << (2 * k)) - 1)
    hi_mask = np.uint32((1 << (2 * k - 32)) - 1) if 2 * k > 32 else np.uint32(0)

    kk = probe_key(minval)
    base = _fastrange32(kk, d.num_slots) & ~np.int64(ROWW - 1)
    fp = (kk & np.uint32(0x7FFF)).astype(np.uint32)
    flat = d.slots.reshape(-1, 3)
    left64 = left.astype(np.int64)
    right64 = right.astype(np.int64)
    for s in range(SCAN):
        rows = flat[np.minimum(base + s, len(flat) - 1)]
        wlo = rows[:, 0].astype(np.int64)
        cs = rows[:, 1]
        ms = rows[:, 2]
        sp = ((ms >> np.uint32(8)) & np.uint32(0x7F)).astype(np.int64)
        cov = (ms >> np.uint32(15)) & np.uint32(1)
        okc = usable & (sp > 0) & (
            ((ms >> np.uint32(16)) & np.uint32(0x7FFF)) == fp) & (cov == 0)
        mo = (ms & np.uint32(0xFF)).astype(np.int64)
        mpos = wlo + mo
        for q, wl, wh in (
            (mpos - left64, flo, fhi),
            (mpos - (k - m) + right64, rlo, rhi),
        ):
            cand = okc & (q >= wlo) & (q < wlo + sp) & ~hit
            ci = np.flatnonzero(cand)
            if len(ci):
                tlo, thi = extract33_host(d.text32, q[ci])
                ok2 = ((tlo & lo_mask) == wl[ci]) & ((thi & hi_mask) == wh[ci])
                sel = ci[ok2]
                hit[sel] = True
                out[sel] = cs[sel]
    rem = np.flatnonzero(usable & ~hit)
    if len(rem):
        # exact skew route: verify EVERY fp8-matching pointer (the skew
        # table only holds true k-mers, so probing ungated windows is just
        # a guaranteed miss — no gating needed for exactness)
        klo, khi = canonical_lsb_np(flo[rem], fhi[rem], rlo[rem], rhi[rem])
        _cnt2, pairs_i, pairs_s = skew_candidates_host(d.sec_table, klo, khi)
        rhit = np.zeros(len(rem), dtype=bool)
        for pi, ps in zip(pairs_i, pairs_s):
            if not len(pi):
                continue
            act = ~rhit[pi]
            pi, ps = pi[act], ps[act]
            if not len(pi):
                continue
            ent = flat[ps]
            wloe = ent[:, 0].astype(np.int64)
            cse = ent[:, 1]
            mse = ent[:, 2]
            spe = ((mse >> np.uint32(8)) & np.uint32(0x7F)).astype(np.int64)
            moe = (mse & np.uint32(0xFF)).astype(np.int64)
            mpos = wloe + moe
            g = rem[pi]
            for q, wl, wh in (
                (mpos - left64[g], flo[g], fhi[g]),
                (mpos - (k - m) + right64[g], rlo[g], rhi[g]),
            ):
                cand = (spe > 0) & (q >= wloe) & (q < wloe + spe) & ~rhit[pi]
                ci = np.flatnonzero(cand)
                if len(ci):
                    tlo, thi = extract33_host(d.text32, q[ci])
                    ok2 = ((tlo & lo_mask) == wl[ci]) & ((thi & hi_mask) == wh[ci])
                    sel = ci[ok2]
                    rhit[pi[sel]] = True
                    hit[g[sel]] = True
                    out[g[sel]] = cse[sel]
    return hit, out


# --------------------------------------------------------------------------
# device (JAX) probe — must mirror lookup_host_device_sem exactly
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# device (JAX) probe — must mirror lookup_host_device_sem exactly
# --------------------------------------------------------------------------


def _make_extract33(text32):
    """33-base text extractor: q (base position) -> (lo, hi) u32 pair of
    LSB-first 2-bit codes starting at q (enough for k <= 33)."""
    import jax.numpy as jnp

    def extract33(q):
        row = jnp.take(text32, jnp.clip(q >> 5, 0, text32.shape[0] - 1), axis=0)
        sh = (2 * (q & 31)).astype(jnp.uint32)
        big = sh >= 32
        s2 = jnp.where(big, sh - 32, sh)
        a0 = jnp.where(big, row[..., 1], row[..., 0])
        a1 = jnp.where(big, row[..., 2], row[..., 1])
        a2 = jnp.where(big, row[..., 3], row[..., 2])
        nz = s2 > 0
        inv = jnp.where(nz, jnp.uint32(32) - s2, jnp.uint32(1))
        lo = jnp.where(nz, (a0 >> s2) | (a1 << inv), a0)
        hi = jnp.where(nz, (a1 >> s2) | (a2 << inv), a1)
        return lo, hi

    return extract33


def skew_probe_device(skew, flat_slots, flo, fhi, rlo, rhi, iL, iR,
                      sigL, sigR, gate,
                      hit, val, *, k: int, m: int, lo_mask, hi_mask,
                      extract33, entry=None, sc: int | None = None):
    """Device skew route (mirror of the SKEW_CAND-capped host semantics):
    select the first SKEW_CAND fp8-matching pointers in probe order, gather
    their primary entries, text-verify the strand-compatible in-span
    orientation (ONE extract per candidate; see the strand-bit notes in
    _probe_entries). -> (hit, val, skew_cnt, tie, entry): `tie` marks lanes
    where some candidate had BOTH orientations viable and the probed one
    missed — the caller overflows those to the exact fallback. Non-gated
    lanes gather row/slot 0.
    entry: optional (q, rc, wlo, sp) winning-candidate tracking arrays,
    updated where this route lands a NEW hit (run-anchored probing)."""
    import jax.numpy as jnp

    from .lookup import mix32, mulhi32

    take_f = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    klo = jnp.where(take_f, flo, rlo)
    khi = jnp.where(take_f, fhi, rhi)
    NR = skew.shape[0]
    h1 = mix32(klo ^ mix32(khi ^ jnp.uint32(SKEW_SEED1)))
    h2 = mix32(klo ^ mix32(khi ^ jnp.uint32(SKEW_SEED2)))
    fp8 = h1 & jnp.uint32(0xFF)
    if sc is None:
        sc = SKEW_CAND
    cnt2 = jnp.zeros(klo.shape, jnp.int32)
    tie = jnp.zeros(klo.shape, bool)
    sid = [jnp.zeros(klo.shape, jnp.int32) for _ in range(sc)]
    for h in (h1, h2):
        r = jnp.where(gate, mulhi32(h, NR).astype(jnp.int32), 0)
        row = jnp.take(skew, r, axis=0)
        for e in range(SKEW_ROWW):
            v = row[..., e]
            mca = gate & (v != 0) & ((v & jnp.uint32(0xFF)) == fp8)
            for j in range(sc):
                upd = mca & (cnt2 == j)
                sid[j] = jnp.where(upd, (v >> jnp.uint32(8)).astype(jnp.int32) - 1,
                                   sid[j])
            cnt2 = cnt2 + mca.astype(jnp.int32)
    for j in range(sc):
        has = gate & (cnt2 > j) & ~hit
        ent = jnp.take(flat_slots, jnp.where(has, sid[j], 0), axis=0)
        wlo = ent[..., 0].astype(jnp.int32)
        cs = ent[..., 1]
        ms = ent[..., 2]
        sp = ((ms >> 8) & jnp.uint32(0x7F)).astype(jnp.int32)
        st = (ms >> 31) == 1
        mo = (ms & jnp.uint32(0xFF)).astype(jnp.int32)
        mpos = wlo + mo
        # ONE text extract per candidate: the strand filter (see
        # _probe_entries) leaves at most one viable orientation except for
        # inverted-repeat minimizers (both in-span AND strand-compatible);
        # the fwd derivation is probed first (host mirror order) and the
        # unprobed-rc case reports `tie` for the caller's ovf.
        q_f = mpos - iL
        q_r = mpos - (k - m) + iR
        span_ok = has & (sp > 0)
        cand_f = span_ok & (q_f >= wlo) & (q_f < wlo + sp) & (sigL == st)
        cand_r = span_ok & (q_r >= wlo) & (q_r < wlo + sp) & (sigR != st)
        cand1 = cand_f | cand_r
        q1 = jnp.where(cand_f, q_f, q_r)
        tlo, thi = extract33(jnp.where(cand1, q1, 0))
        want_lo = jnp.where(cand_f, flo, rlo)
        want_hi = jnp.where(cand_f, fhi, rhi)
        okv = cand1 & ((tlo & lo_mask) == want_lo) & (
            (thi & hi_mask) == want_hi)
        tie = tie | (cand_f & cand_r & ~okv)
        new = okv & ~hit
        val = jnp.where(new, cs, val)
        if entry is not None:
            e_q, e_rc, e_wlo, e_sp = entry
            entry = (
                jnp.where(new, q1, e_q),
                jnp.where(new, ~cand_f, e_rc),
                jnp.where(new, wlo, e_wlo),
                jnp.where(new, sp, e_sp),
            )
        hit = hit | okv
    return hit, val, cnt2, tie, entry


def _rev2_32(x):
    """Reverse the 16 2-bit groups of a uint32 (butterfly, 4 steps)."""
    import jax.numpy as jnp

    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def _device_pack_codes(codes):
    """(B, L) int codes -> (words (B, ceil(L/16)) u32 LSB-first 16 bases
    each, badw (B, ceil(L/32)) u32 one bad-bit per base). One pass over the
    batch (the round-2 prep re-sliced it ~50 times)."""
    import jax.numpy as jnp

    B, L = codes.shape
    c = codes.astype(jnp.uint32)
    bad = c > 3
    c = jnp.where(bad, 0, c)
    Lw = -(-L // 16) * 16
    if Lw != L:
        c = jnp.pad(c, ((0, 0), (0, Lw - L)))
    sh16 = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    words = jnp.sum(c.reshape(B, Lw // 16, 16) << sh16, axis=2,
                    dtype=jnp.uint32)
    Lb = -(-L // 32) * 32
    badp = bad
    if Lb != L:
        badp = jnp.pad(bad, ((0, 0), (0, Lb - L)), constant_values=True)
    sh32 = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    badw = jnp.sum(badp.astype(jnp.uint32).reshape(B, Lb // 32, 32) << sh32,
                   axis=2, dtype=jnp.uint32)
    return words, badw


def words_from_packed(codes2, bad):
    """Reinterpret the host-packed stream buffers (pack_reads_host layout:
    codes2 (B, W//4) u8 LSB-first, bad (B, W//8) u8 bit-per-base) as the
    (words, badw) u32 arrays _window_prep_from_words consumes — zero
    recompute, the wire format IS the prep format."""
    import jax.numpy as jnp

    B = codes2.shape[0]
    c = codes2.astype(jnp.uint32)
    words = (c[:, 0::4] | (c[:, 1::4] << 8) | (c[:, 2::4] << 16)
             | (c[:, 3::4] << 24))
    b = bad.astype(jnp.uint32)
    badw = (b[:, 0::4] | (b[:, 1::4] << 8) | (b[:, 2::4] << 16)
            | (b[:, 3::4] << 24))
    return words, badw


def _extract_all(words, nout: int):
    """32-base LSB-first extraction at EVERY base position p < nout:
    lo(p) = bases [p, p+16), hi(p) = bases [p+16, p+32). Built by 16
    alignment shifts + one interleave — no gathers."""
    import jax.numpy as jnp

    B, nw = words.shape
    need = (max(nout, 1) - 1) // 16 + 3
    if nw < need:
        words = jnp.pad(words, ((0, 0), (0, need - nw)))
    w0, w1, w2 = words[:, :-2], words[:, 1:-1], words[:, 2:]
    los, his = [], []
    for a in range(16):
        s = 2 * a
        if s == 0:
            los.append(w0)
            his.append(w1)
        else:
            los.append((w0 >> s) | (w1 << (32 - s)))
            his.append((w1 >> s) | (w2 << (32 - s)))
    lo = jnp.stack(los, axis=2).reshape(B, -1)[:, :nout]
    hi = jnp.stack(his, axis=2).reshape(B, -1)[:, :nout]
    return lo, hi


def _extract_bits_all(badw, nout: int):
    """32 bad-bits starting at every base position p < nout."""
    import jax.numpy as jnp

    B, nb = badw.shape
    need = (max(nout, 1) - 1) // 32 + 2
    if nb < need:
        # absent positions are PAD: mark bad so no window uses them
        badw = jnp.pad(badw, ((0, 0), (0, need - nb)),
                       constant_values=np.uint32(0xFFFFFFFF))
    b0, b1 = badw[:, :-1], badw[:, 1:]
    outs = []
    for a in range(32):
        outs.append(b0 if a == 0 else (b0 >> a) | (b1 << (32 - a)))
    return jnp.stack(outs, axis=2).reshape(B, -1)[:, :nout]


def _window_prep_from_words(words, badw, L: int, k: int, m: int):
    """Core prep from 2-bit packed words: see _window_prep. All per-window
    packings derive from ONE 32-base extraction pass; reverse complements
    via a 2-bit butterfly (rc_lsb(n-mer) = rev2_64(~fwd)>>（64-2n)), and
    the m-mer big-endian canonicals from the same identities (big_fwd =
    rev2 of lsb, big_rc = ~lsb) — bit-identical to the host mmer_hashes /
    window_packings_lsb definitions."""
    import jax
    import jax.numpy as jnp

    from .lookup import mix32

    B = words.shape[0]
    Wk = L - k + 1
    Wm = L - m + 1
    w = k - m + 1

    lo, hi = _extract_all(words, Wm)
    badx = _extract_bits_all(badw, Wm)
    nl, nh = ~lo, ~hi
    Rl, Rh = _rev2_32(nl), _rev2_32(nh)  # rev2 of complements

    def _masks(n):
        lom = jnp.uint32(0xFFFFFFFF if 2 * n >= 32 else (1 << (2 * n)) - 1)
        him = jnp.uint32((1 << (2 * n - 32)) - 1 if 2 * n > 32 else 0)
        return lom, him

    def _rc_pair(n):
        s = 64 - 2 * n
        if s == 0:
            return Rh, Rl
        if s < 32:
            return (Rh >> s) | (Rl << (32 - s)), Rl >> s
        if s == 32:
            return Rl, jnp.zeros_like(Rl)
        return Rl >> (s - 32), jnp.zeros_like(Rl)

    # ---- k-mer fwd/rc LSB packings over the k-window positions ----
    klom, khim = _masks(k)
    flo = (lo & klom)[:, :Wk]
    fhi = (hi & khim)[:, :Wk]
    rkl, rkh = _rc_pair(k)
    rlo = (rkl & klom)[:, :Wk]
    rhi = (rkh & khim)[:, :Wk]
    kbm = jnp.uint32((1 << k) - 1) if k < 32 else jnp.uint32(0xFFFFFFFF)
    okw = ((badx & kbm) == 0)[:, :Wk]

    # ---- m-mer canonical (big-endian) hashes over all Wm positions ----
    mlom, mhim = _masks(m)
    br_lo = nl & mlom                     # big_rc = ~fwd_lsb
    br_hi = nh & mhim
    iRl, iRh = ~Rl, ~Rh                   # rev2(lo), rev2(hi)
    s = 64 - 2 * m
    if s == 0:
        bf_lo, bf_hi = iRh & mlom, iRl & mhim
    elif s < 32:
        bf_lo = ((iRh >> s) | (iRl << (32 - s))) & mlom
        bf_hi = (iRl >> s) & mhim
    elif s == 32:
        bf_lo, bf_hi = iRl & mlom, jnp.zeros_like(iRl)
    else:
        bf_lo = (iRl >> (s - 32)) & mlom
        bf_hi = jnp.zeros_like(iRl)
    take_f = (bf_hi < br_hi) | ((bf_hi == br_hi) & (bf_lo <= br_lo))
    lo_m = jnp.where(take_f, bf_lo, br_lo)
    hi_m = jnp.where(take_f, bf_hi, br_hi)
    mbm = jnp.uint32((1 << m) - 1)
    ok_m = (badx & mbm) == 0
    h = mix32(lo_m ^ mix32(hi_m ^ jnp.uint32(SEED_M)))
    h = jnp.where(h == jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFE), h)
    h = jnp.where(ok_m, h, jnp.uint32(0xFFFFFFFF))

    # ---- sliding min + leftmost/rightmost argmin ----
    # The scan also carries take_f (fwd m-mer == canonical) at the argmin:
    # the strand of the winning minimizer occurrence resolves candidate
    # orientation against the entry's stored strand bit, so each slot entry
    # spawns ONE oriented candidate instead of two (halving the verify
    # budget the probe needs for the same coverage).
    pos = jnp.broadcast_to(jax.lax.broadcasted_iota(jnp.int32, (1, Wm), 1), (B, Wm))
    vL, pL, sL, vR, pR, sR = h, pos, take_f, h, pos, take_f
    span = 1
    while span < w:
        step = min(span, w - span)
        bvL, bpL, bsL = vL[:, step:], pL[:, step:], sL[:, step:]
        nL = vL.shape[1] - step
        avL, apL, asL = vL[:, :nL], pL[:, :nL], sL[:, :nL]
        tL = (bvL < avL) | ((bvL == avL) & (bpL < apL))
        vL, pL = jnp.where(tL, bvL, avL), jnp.where(tL, bpL, apL)
        sL = jnp.where(tL, bsL, asL)
        bvR, bpR, bsR = vR[:, step:], pR[:, step:], sR[:, step:]
        avR, apR, asR = vR[:, :nL], pR[:, :nL], sR[:, :nL]
        tR = (bvR < avR) | ((bvR == avR) & (bpR > apR))
        vR, pR = jnp.where(tR, bvR, avR), jnp.where(tR, bpR, apR)
        sR = jnp.where(tR, bsR, asR)
        span += step
    minval = vL[:, :Wk]
    kpos = jnp.broadcast_to(jax.lax.broadcasted_iota(jnp.int32, (1, Wk), 1), (B, Wk))
    pLabs = pL[:, :Wk]
    pRabs = pR[:, :Wk]
    iL = pLabs - kpos
    iR = pRabs - kpos
    sigL = sL[:, :Wk]
    sigR = sR[:, :Wk]

    usable = okw & (minval != jnp.uint32(0xFFFFFFFF))
    return (minval, iL, iR, pLabs, pRabs, sigL, sigR, flo, fhi, rlo, rhi,
            usable)


def _window_prep(codes, k: int, m: int):
    """Per-window minimizer + packing preamble shared by the probe variants.

    -> (minval, iL, iR, pLabs, pRabs, sigL, sigR, flo, fhi, rlo, rhi,
    usable), all (B, Wk); pLabs/pRabs are the ABSOLUTE read positions of the
    leftmost / rightmost minimal m-mer in each window (run anchoring keys
    off them); sigL/sigR are take_f (fwd == canonical) at those positions
    (the strand filter's read side)."""
    B, L = codes.shape
    words, badw = _device_pack_codes(codes)
    return _window_prep_from_words(words, badw, L, k, m)


def _probe_entries(slots, text32, sec_table, minval, iL, iR, sigL, sigR,
                   flo, fhi, rlo, rhi, usable, *, k: int, m: int,
                   num_slots: int, gate=None,
                   want_entry: bool = False, vb: int | None = None,
                   sc: int | None = None, stage1: bool = False):
    """Full per-lane probe: slot-window candidate screen, text verify, skew
    route. Semantics == lookup_host_device_sem per lane (at the default
    budgets).

    gate: optional bool mask — lanes outside it coalesce every gather onto
    row/slot 0 and report no hit/ovf (the run-anchored probe's stage gate).
    want_entry: also return the WINNING candidate's (q, rc, wlo, sp) so run
    anchoring can derive neighbor windows' candidate text positions.
    vb/sc: per-call VERIFY_BUDGET/SKEW_CAND overrides. Budget-trimmed
    probes stay EXACT where they decide — a hit is text-verified, a
    non-ovf miss exhausted all candidates — they only raise ovf more
    often, and ovf reads re-derive through a full-budget redo kernel
    (QueryEngine._device_csids_many). Each verify or skew candidate adds
    gathers over the whole lane grid, so the engine's main kernels run
    trimmed budgets and the redo kernel (8, 4).
    stage1: stop after the slot-window verifies and return
    (hit, val, cnt, need_sec) — the staged probe's cheap first pass (no
    skew gathers on the full lane grid at all; see _probe_staged).
    -> (hit, val, ovf[, entry]) or the stage1 4-tuple."""
    import jax.numpy as jnp

    from .lookup import mix32, mulhi32

    if vb is None:
        vb = VERIFY_BUDGET
    if sc is None:
        sc = SKEW_CAND
    use = usable if gate is None else (usable & gate)
    B, Wk = minval.shape

    # ---- probe key, bucket, fingerprint (15 bits; bit 31 of the meta
    # word is the entry's text-strand bit) ----
    kk = mix32(minval)
    b = mulhi32(kk, num_slots).astype(jnp.int32)
    fp = kk & jnp.uint32(0x7FFF)
    rsh = ROWW.bit_length() - 1
    baseR = (b >> rsh)  # row of (b & ~(ROWW-1)); SCAN/ROWW row gathers

    def _row_addr(j):
        adr = jnp.clip(baseR + j, 0, slots.shape[0] - 1)
        return adr if gate is None else jnp.where(gate, adr, 0)

    rows = [jnp.take(slots, _row_addr(j), axis=0) for j in range(SCAN // ROWW)]

    lo_mask = jnp.uint32(0xFFFFFFFF) if 2 * k >= 32 else jnp.uint32((1 << (2 * k)) - 1)
    hi_mask = jnp.uint32((1 << (2 * k - 32)) - 1) if 2 * k > 32 else jnp.uint32(0)

    # ---- candidate selection: first VERIFY_BUDGET in slot order ----
    # need_sec: this window's minimizer group is covered or spilled (its
    # fingerprint appears with the covered bit), or the window is full (a
    # tombstone could not even be placed) — only those windows gather the
    # secondary; the rest coalesce onto row 0.
    cnt = jnp.zeros((B, Wk), jnp.int32)
    need_sec = jnp.zeros((B, Wk), bool)
    n_occ = jnp.zeros((B, Wk), jnp.int32)
    q_sel = [jnp.zeros((B, Wk), jnp.int32) for _ in range(vb)]
    o_sel = [jnp.zeros((B, Wk), bool) for _ in range(vb)]
    cs_sel = [jnp.zeros((B, Wk), jnp.uint32) for _ in range(vb)]
    if want_entry:
        w_sel = [jnp.zeros((B, Wk), jnp.int32) for _ in range(vb)]
        s_sel = [jnp.zeros((B, Wk), jnp.int32) for _ in range(vb)]
    for s in range(SCAN):
        row = rows[s // ROWW]
        off = 3 * (s % ROWW)
        wlo = row[..., off].astype(jnp.int32)
        cs = row[..., off + 1]
        ms = row[..., off + 2]
        sp = ((ms >> 8) & jnp.uint32(0x7F)).astype(jnp.int32)
        cov = (ms >> 15) & jnp.uint32(1)
        efp = (ms >> 16) & jnp.uint32(0x7FFF)
        st = (ms >> 31) == 1
        need_sec = need_sec | ((cov == 1) & (efp == fp))
        n_occ = n_occ + ((sp > 0) | (cov == 1)).astype(jnp.int32)
        okc = use & (sp > 0) & (efp == fp) & (cov == 0)
        mo = (ms & jnp.uint32(0xFF)).astype(jnp.int32)
        mpos = wlo + mo
        # strand filter: a fwd candidate can only match when the window's
        # winning minimizer occurrence has the same strand as the entry's
        # stored occurrence (odd m: no palindromic m-mers, so strand
        # mismatch PROVES the text compare would fail)
        for orient, q, sok in (
            (False, mpos - iL, sigL == st),
            (True, mpos - (k - m) + iR, sigR != st),
        ):
            cand = okc & sok & (q >= wlo) & (q < wlo + sp)
            for j in range(vb):
                upd = cand & (cnt == j)
                q_sel[j] = jnp.where(upd, q, q_sel[j])
                o_sel[j] = jnp.where(upd, orient, o_sel[j])
                cs_sel[j] = jnp.where(upd, cs, cs_sel[j])
                if want_entry:
                    w_sel[j] = jnp.where(upd, wlo, w_sel[j])
                    s_sel[j] = jnp.where(upd, sp, s_sel[j])
            cnt = cnt + cand.astype(jnp.int32)
    need_sec = need_sec | (n_occ >= SCAN)

    # ---- verification ----
    extract33 = _make_extract33(text32)

    hit = jnp.zeros((B, Wk), bool)
    val = jnp.full((B, Wk), INVALID_U32, dtype=jnp.uint32)
    entry = None
    if want_entry:
        entry = (
            jnp.zeros((B, Wk), jnp.int32),   # q (window start in text)
            jnp.zeros((B, Wk), bool),        # rc orientation
            jnp.zeros((B, Wk), jnp.int32),   # entry wlo
            jnp.zeros((B, Wk), jnp.int32),   # entry span
        )
    for j in range(vb):
        has = cnt > j
        tlo, thi = extract33(jnp.where(has, q_sel[j], 0))
        tlo = tlo & lo_mask
        thi = thi & hi_mask
        want_lo = jnp.where(o_sel[j], rlo, flo)
        want_hi = jnp.where(o_sel[j], rhi, fhi)
        okv = has & (tlo == want_lo) & (thi == want_hi)
        new = okv & ~hit
        val = jnp.where(new, cs_sel[j], val)
        if want_entry:
            e_q, e_rc, e_wlo, e_sp = entry
            entry = (
                jnp.where(new, q_sel[j], e_q),
                jnp.where(new, o_sel[j], e_rc),
                jnp.where(new, w_sel[j], e_wlo),
                jnp.where(new, s_sel[j], e_sp),
            )
        hit = hit | okv

    if stage1:
        return hit, val, cnt, need_sec

    # ---- skew route (covered/heavy-minimizer k-mers), gathered only where
    # gated — everyone else coalesces onto row/slot 0 ----
    gate2 = use & ~hit & need_sec
    flat_slots = slots.reshape(-1, 3)
    hit, val, cnt2, tie, entry = skew_probe_device(
        sec_table, flat_slots, flo, fhi, rlo, rhi, iL, iR, sigL, sigR,
        gate2, hit, val,
        k=k, m=m, lo_mask=lo_mask, hi_mask=hi_mask, extract33=extract33,
        entry=entry, sc=sc,
    )

    # tie: both orientations of some skew candidate were strand-compatible
    # and in-span (an inverted-repeat minimizer — vanishingly rare) and the
    # probed one missed; the lane cannot prove absence without the second
    # extract the fused route no longer performs, so it overflows to the
    # exact fallback instead.
    ovf = (use & ~hit & (cnt > vb)) | (
        gate2 & ~hit & ((cnt2 > sc) | tie)
    )
    val = jnp.where(hit, val, jnp.uint32(INVALID_U32))
    if want_entry:
        return hit, val, ovf, entry
    return hit, val, ovf


def lookup_minidict2_batch(slots, text32, sec_table, codes, *, k: int, m: int,
                           num_slots: int, probe_budget=None):
    """Batched bucketless-minidict lookup (device).

    codes: (B, L) int codes (0..3 valid, >=4 pad). -> (hit (B,Wk) bool,
    csid (B,Wk) u32, ovf (B,Wk) bool). Semantics == lookup_host_device_sem
    at the default probe_budget (see _probe_entries on trimmed budgets).
    """
    prep = _window_prep(codes, k, m)
    return _probe_per_window(slots, text32, sec_table, prep, k, m, num_slots,
                             probe_budget)


def lookup_minidict2_packed(slots, text32, sec_table, codes2, bad, *,
                            width: int, k: int, m: int, num_slots: int,
                            probe_budget=None):
    """Per-window lookup straight from the host-packed stream buffers
    (pack_reads_host layout) — the wire format doubles as the prep input,
    so no device-side unpack/re-pack happens at all."""
    words, badw = words_from_packed(codes2, bad)
    prep = _window_prep_from_words(words, badw, width, k, m)
    return _probe_per_window(slots, text32, sec_table, prep, k, m, num_slots,
                             probe_budget)


def _probe_per_window(slots, text32, sec_table, prep, k, m, num_slots,
                      probe_budget=None):
    (minval, iL, iR, _pL, _pR, sigL, sigR, flo, fhi, rlo, rhi,
     usable) = prep
    vb, sc = probe_budget if probe_budget is not None else (None, None)
    return _probe_entries(
        slots, text32, sec_table, minval, iL, iR, sigL, sigR, flo, fhi,
        rlo, rhi, usable,
        k=k, m=m, num_slots=num_slots, vb=vb, sc=sc,
    )


def lookup_minidict2_staged_packed(slots, text32, sec_table, codes2, bad, *,
                                   width: int, k: int, m: int, num_slots: int,
                                   vb1: int = 2, vb2: int = 8, sc: int = 4,
                                   RU: int = 16):
    """Staged-verify per-window lookup from packed stream buffers (the
    probe-cost lever identified in DESIGN-NOTES §17/§18):

      stage A   every lane: slot-window screen + vb1 text verifies, NO skew
                gathers anywhere (the skew route alone was 41% of the
                one-pass probe, and 4 of 6 verify extracts go unused on
                typical lanes).
      tier B1   per read, up to RU undecided windows (cnt > vb1, or a
                covered/parked fingerprint needing the skew table) compact
                into (B, RU) lanes and run the FULL probe (vb2, sc).
      tier B2   reads with MORE than RU undecided windows (covered-region
                reads: every window of a heavy-minimizer stretch needs the
                skew table, so a per-window budget would flood — §17's
                error-flood lesson) gather WHOLE into a (B//8, Wk) sub-
                batch for the full probe; reads past that sub-batch budget
                report ovf and redo via the engine's exact fallback.

    Exactness contract unchanged: a hit is text-verified, a non-ovf miss
    exhausted every candidate; staged == one-pass(vb2, sc) wherever ovf is
    False. -> (hit, csid, ovf)."""
    words, badw = words_from_packed(codes2, bad)
    prep = _window_prep_from_words(words, badw, width, k, m)
    return _probe_staged(slots, text32, sec_table, prep, k, m, num_slots,
                         vb1, vb2, sc, RU)


def _probe_staged(slots, text32, sec_table, prep, k, m, num_slots,
                  vb1, vb2, sc, RU):
    import jax
    import jax.numpy as jnp

    from .intersect import mask_positions

    (minval, iL, iR, _pL, _pR, sigL, sigR, flo, fhi, rlo, rhi,
     usable) = prep
    B, Wk = minval.shape
    RU = min(RU, Wk)
    BH = max(1, B // 8)

    # ---- stage A: screen + vb1 verifies on every lane ----
    hit, val, cnt, need_sec = _probe_entries(
        slots, text32, sec_table, minval, iL, iR, sigL, sigR, flo, fhi,
        rlo, rhi, usable,
        k=k, m=m, num_slots=num_slots, vb=vb1, stage1=True,
    )
    undec = usable & ~hit & ((cnt > vb1) | need_sec)
    nU = jnp.sum(undec.astype(jnp.int32), axis=1)
    heavy = nU > RU
    light_undec = undec & ~heavy[:, None]

    # ---- tier B1: per-read window compaction ----
    totU, posU = mask_positions(light_undec, RU)
    laneU = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (1, RU), 1), (B, RU))
    validU = laneU < totU[:, None]

    def gU(a):
        return jnp.take_along_axis(a, posU, axis=1)

    hitU, valU, ovfU = _probe_entries(
        slots, text32, sec_table, gU(minval), gU(iL), gU(iR), gU(sigL),
        gU(sigR), gU(flo), gU(fhi), gU(rlo), gU(rhi), validU,
        k=k, m=m, num_slots=num_slots, gate=validU, vb=vb2, sc=sc,
    )
    urank = jnp.cumsum(light_undec.astype(jnp.int32), axis=1) - 1
    ur = jnp.clip(urank, 0, RU - 1)
    hitU_w = jnp.take_along_axis(hitU, ur, axis=1) & light_undec
    valU_w = jnp.take_along_axis(valU, ur, axis=1)
    ovfU_w = jnp.take_along_axis(ovfU, ur, axis=1) & light_undec

    # ---- tier B2: whole-read compaction for heavy (covered-region) reads
    totH, posH = mask_positions(heavy[None, :], BH)
    posH = posH[0]
    validH = jnp.arange(BH, dtype=jnp.int32) < totH[0]

    def gH(a):
        return jnp.take(a, posH, axis=0)

    useH = gH(undec) & validH[:, None]
    hitH, valH, ovfH = _probe_entries(
        slots, text32, sec_table, gH(minval), gH(iL), gH(iR), gH(sigL),
        gH(sigR), gH(flo), gH(fhi), gH(rlo), gH(rhi), useH,
        k=k, m=m, num_slots=num_slots, gate=useH, vb=vb2, sc=sc,
    )
    hrank = jnp.cumsum(heavy.astype(jnp.int32)) - 1
    in_h = heavy & (hrank < BH)
    hr = jnp.clip(hrank, 0, BH - 1)
    sel_h = in_h[:, None] & undec
    hitH_w = jnp.take(hitH, hr, axis=0) & sel_h
    valH_w = jnp.take(valH, hr, axis=0)
    ovfH_w = (jnp.take(ovfH, hr, axis=0) & sel_h) | (
        (heavy & (hrank >= BH))[:, None] & undec)

    hit_f = hit | hitU_w | hitH_w
    val_f = jnp.where(hit, val,
                      jnp.where(hitU_w, valU_w,
                                jnp.where(hitH_w, valH_w,
                                          jnp.uint32(INVALID_U32))))
    ovf = ovfU_w | ovfH_w
    return hit_f, val_f, ovf


def anchor_budget(Wk: int, k: int, m: int) -> int:
    """Anchor lanes per side for a Wk-window read: expected minimizer-run
    count is ~2*Wk/(w+1) for w = k-m+1 random-minimizer windows (SSHash's
    density argument, SURVEY §2.2); budget = 1.6x expected + slack so only
    tail reads overflow (they redo via the per-window kernel)."""
    w = k - m + 1
    return min(Wk, max(8, (16 * Wk) // (5 * (w + 1)) + 8))


def reprobe_budget(Wk: int, k: int, m: int) -> int:
    """Undecided-window reprobe lanes: on corpus-matching reads undecided
    windows cluster at unitig-boundary crossings (~run-remainder sized);
    read errors shatter the local run structure, so give the same head
    room as the anchor side — heavier reads redo via the per-window
    kernel."""
    w = k - m + 1
    return min(Wk, max(8, (16 * Wk) // (5 * (w + 1)) + 8))


def lookup_minidict2_batch_anchored(slots, text32, sec_table, codes, *,
                                    k: int, m: int, num_slots: int,
                                    RA: int | None = None,
                                    RU: int | None = None):
    """Run-anchored batched lookup v2, on COMPACTED lanes.

    The round-2 variant gated two full probe passes on all (B, Wk) window
    lanes; gather ops cost by LANE COUNT even when lanes are inactive, so
    it measured 2x slower end-to-end. v2 spends full probes only on
    compacted anchor lanes:

      1. runs = maximal window stretches with constant (leftmost,
         rightmost) minimal m-mer position; within one, the candidate text
         position advances +1/window forward and -1/window for rc (the
         per-window probe's own q formula in _probe_entries).
      2. Rank run STARTS and ENDS with popcount math (mask_positions) and
         gather their probe inputs into (B, 2*RA) lanes; one full probe
         decides every anchor window and yields its winning entry.
      3. Every window verifies ONE predicted text position from its run's
         start anchor (one coalesced extract), and — where that fails —
         one from its end anchor (second extract, gated). Start+end cover
         both sides of mid-run unitig-boundary crossings.
      4. Windows still undecided (anchor missed + prediction failed:
         read errors, boundary stragglers) are compacted into (B, RU)
         lanes and re-probed exactly. Merges back are rank-gathers — no
         scatters anywhere.

    Reads that overflow RA or RU (or hit probe-lane ovf) report ovf on
    their windows; the caller redoes them (device per-window kernel or
    exact host probe). Result contract vs lookup_minidict2_batch: hit is
    a superset where both decide, csid agrees everywhere both hit, and
    ovf covers every window the per-window kernel would leave undecided.
    """
    prep = _window_prep(codes, k, m)
    return _probe_anchored(slots, text32, sec_table, prep, k, m, num_slots,
                           RA, RU)


def lookup_minidict2_anchored_packed(slots, text32, sec_table, codes2, bad, *,
                                     width: int, k: int, m: int,
                                     num_slots: int, RA=None, RU=None):
    """Anchored lookup from host-packed stream buffers (see
    lookup_minidict2_packed)."""
    words, badw = words_from_packed(codes2, bad)
    prep = _window_prep_from_words(words, badw, width, k, m)
    return _probe_anchored(slots, text32, sec_table, prep, k, m, num_slots,
                           RA, RU)


def _probe_anchored(slots, text32, sec_table, prep, k, m, num_slots, RA, RU):
    import jax
    import jax.numpy as jnp

    from .intersect import mask_positions

    (minval, iL, iR, pLabs, pRabs, sigL, sigR, flo, fhi, rlo, rhi,
     usable) = prep
    B, Wk = minval.shape
    if RA is None:
        RA = anchor_budget(Wk, k, m)
    if RU is None:
        RU = reprobe_budget(Wk, k, m)
    pos = jnp.broadcast_to(jax.lax.broadcasted_iota(jnp.int32, (1, Wk), 1), (B, Wk))

    prev_ok = jnp.concatenate([jnp.zeros((B, 1), bool), usable[:, :-1]], axis=1)
    sameL = jnp.concatenate(
        [jnp.zeros((B, 1), bool), pLabs[:, 1:] == pLabs[:, :-1]], axis=1
    )
    sameR = jnp.concatenate(
        [jnp.zeros((B, 1), bool), pRabs[:, 1:] == pRabs[:, :-1]], axis=1
    )
    is_start = usable & ~(prev_ok & sameL & sameR)
    next_ok = jnp.concatenate([usable[:, 1:], jnp.zeros((B, 1), bool)], axis=1)
    is_end = usable & ~(next_ok & jnp.concatenate(
        [sameL[:, 1:], jnp.zeros((B, 1), bool)], axis=1
    ) & jnp.concatenate([sameR[:, 1:], jnp.zeros((B, 1), bool)], axis=1))

    totS, posS = mask_positions(is_start, RA)
    _totE, posE = mask_positions(is_end, RA)
    lane = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (1, RA), 1), (B, RA)
    )
    validS = lane < totS[:, None]
    # runs of length 1 have posE == posS: the start probe already decides
    # them, so their end lanes stay gated (coalesced to row 0)
    probeE = validS & (posE > posS)

    # gather per-anchor probe inputs; stack start|end halves into one probe
    posA = jnp.concatenate([posS, posE], axis=1)

    def gA(a):
        return jnp.take_along_axis(a, posA, axis=1)

    laneok = jnp.concatenate([validS, probeE], axis=1)
    hitA, valA, ovfA, (qA, rcA, wloA, spA) = _probe_entries(
        slots, text32, sec_table, gA(minval), gA(iL), gA(iR), gA(sigL),
        gA(sigR), gA(flo), gA(fhi), gA(rlo), gA(rhi), laneok,
        k=k, m=m, num_slots=num_slots, gate=laneok, want_entry=True,
    )

    # broadcast each run's anchor results back to its windows: window ->
    # run rank via cumsum, then a tiny take_along gather from the lanes
    runid = jnp.cumsum(is_start.astype(jnp.int32), axis=1) - 1
    in_run = usable & (runid >= 0) & (runid < RA)
    rid = jnp.clip(runid, 0, RA - 1)

    def bS(a):
        return jnp.take_along_axis(a[:, :RA], rid, axis=1)

    def bE(a):
        return jnp.take_along_axis(a[:, RA:], rid, axis=1)

    extract33 = _make_extract33(text32)
    lo_mask = jnp.uint32(0xFFFFFFFF) if 2 * k >= 32 else jnp.uint32((1 << (2 * k)) - 1)
    hi_mask = jnp.uint32((1 << (2 * k - 32)) - 1) if 2 * k > 32 else jnp.uint32(0)

    # --- extension round 1: start-anchor prediction ---
    hS, vS, qS, rcS, wS, sS, ovfS = (
        bS(hitA), bS(valA), bS(qA), bS(rcA), bS(wloA), bS(spA), bS(ovfA))
    dS = pos - bS(jnp.where(validS, posS, 0))
    qwS = jnp.where(rcS, qS - dS, qS + dS)
    extS = in_run & hS & (qwS >= wS) & (qwS < wS + sS)
    tlo, thi = extract33(jnp.where(extS, qwS, 0))
    ok1 = extS & ((tlo & lo_mask) == jnp.where(rcS, rlo, flo)) & (
        (thi & hi_mask) == jnp.where(rcS, rhi, fhi))

    # --- extension round 2: end-anchor prediction, gated on round-1 miss ---
    hE, vE, qE, rcE, wE, sE, ovfE = (
        bE(hitA), bE(valA), bE(qA), bE(rcA), bE(wloA), bE(spA), bE(ovfA))
    dE = jnp.take_along_axis(jnp.where(probeE, posE, 0), rid, axis=1) - pos
    qwE = jnp.where(rcE, qE + dE, qE - dE)
    extE = in_run & ~ok1 & hE & (dE >= 0) & (qwE >= wE) & (qwE < wE + sE)
    tlo, thi = extract33(jnp.where(extE, qwE, 0))
    ok2 = extE & ((tlo & lo_mask) == jnp.where(rcE, rlo, flo)) & (
        (thi & hi_mask) == jnp.where(rcE, rhi, fhi))

    hit0 = ok1 | ok2
    val0 = jnp.where(ok1, vS, vE)

    # anchor windows the probe decided as definitive MISSES (no hit, no
    # lane ovf) must not reach the reprobe
    eprb = jnp.take_along_axis(probeE, rid, axis=1)
    dec_miss = (is_start & in_run & ~ovfS & ~hS) | (
        is_end & in_run & eprb & ~ovfE & ~hE)
    # anchor windows whose own probe lane overflowed: reprobing runs the
    # same algorithm — flag the read for redo instead
    anch_ovf = ((is_start & in_run & ovfS)
                | (is_end & in_run & eprb & ovfE)) & ~hit0

    # --- compacted exact reprobe for the undecided remainder ---
    undec = usable & in_run & ~hit0 & ~dec_miss & ~anch_ovf
    totU, posU = mask_positions(undec, RU)
    laneU = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (1, RU), 1), (B, RU)
    )
    validU = laneU < totU[:, None]

    def gU(a):
        return jnp.take_along_axis(a, posU, axis=1)

    hitU, valU, ovfU = _probe_entries(
        slots, text32, sec_table, gU(minval), gU(iL), gU(iR), gU(sigL),
        gU(sigR), gU(flo), gU(fhi), gU(rlo), gU(rhi), validU,
        k=k, m=m, num_slots=num_slots, gate=validU,
    )
    urank = jnp.cumsum(undec.astype(jnp.int32), axis=1) - 1
    in_ru = undec & (urank < RU)
    ur = jnp.clip(urank, 0, RU - 1)
    hitU_w = jnp.take_along_axis(hitU, ur, axis=1) & in_ru
    valU_w = jnp.take_along_axis(valU, ur, axis=1)
    ovfU_w = (jnp.take_along_axis(ovfU, ur, axis=1) & in_ru) | (
        undec & (urank >= RU))

    hit = hit0 | hitU_w
    val = jnp.where(hit0, val0, jnp.where(hitU_w, valU_w,
                                          jnp.uint32(INVALID_U32)))
    ovf = ovfU_w | anch_ovf | (usable & ~in_run)
    return hit, val, ovf
