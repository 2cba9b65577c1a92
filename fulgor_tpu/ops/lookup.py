"""Device-side k-mer lookup (replaces SSHash streaming_query, SURVEY.md §3.2).

The reference's hottest loop is a per-k-mer minimizer-bucketed dictionary
probe with a streaming fast path. The device formulation is batch-parallel:

  1. pack every k-window of a (B, L) batch of 2-bit read codes into
     (hi, lo) uint32 pairs — O(k) static shift-adds on the VPU, no scan;
  2. canonicalize (min of forward / reverse-complement, big-endian order);
  3. probe a quotient cuckoo table (2 invertible-permutation hashes x 2
     slots): exactly two 16-byte row gathers per k-mer, compare remainders,
     select. No data-dependent loops.

The permutations/layout must match native fn_cuckoo_build and
query/host_lookup. All ops are uint32: 62-bit values travel as (lo, hi) u32
limbs, so the graph needs no 64-bit integer support (jax_enable_x64 off).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import INVALID_U32

SEED1 = 0x8BADF00D  # python ints: traced as uint32 at use sites
SEED2 = 0x5EEDCAFE


def mix32(x):
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def pack_reads_host(chunk):
    """Host-side 2-bit packing of a (B, W) uint8 code chunk (W % 32 == 0):
    -> (codes2 (B, W//4) uint8, bad (B, W//8) uint8 bitmask). Cuts the
    host->device transfer ~2.7x (the upload is a pipeline stage)."""
    import numpy as np

    B, W = chunk.shape
    assert W % 32 == 0
    bad = chunk >= 4
    c = np.where(bad, 0, chunk).astype(np.uint8)
    codes2 = (
        c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    ).astype(np.uint8)
    badm = np.packbits(bad, axis=1, bitorder="little")
    return codes2, badm


def unpack_reads(codes2: jax.Array, bad: jax.Array, width: int) -> jax.Array:
    """Device-side inverse of pack_reads_host -> (B, W) uint8-like codes
    (values 0..3, 4 for invalid/pad)."""
    B = codes2.shape[0]
    c = codes2.astype(jnp.uint32)
    shifts = jnp.arange(4, dtype=jnp.uint32) * 2
    codes = ((c[:, :, None] >> shifts) & jnp.uint32(3)).reshape(B, width)
    b = bad.astype(jnp.uint32)
    bshifts = jnp.arange(8, dtype=jnp.uint32)
    badbits = ((b[:, :, None] >> bshifts) & jnp.uint32(1)).reshape(B, width)
    return jnp.where(badbits == 1, jnp.uint32(4), codes)


def pack_windows(codes: jax.Array, k: int):
    """codes: (B, L) int32 base codes (0..3 valid, >=4 pad/invalid).

    -> (lo, hi, valid): each (B, W=L-k+1); lo/hi uint32 canonical k-mer
    halves, valid bool (window inside read and all bases ACGT).
    """
    B, L = codes.shape
    W = L - k + 1
    assert W >= 1, "batch width shorter than k"
    c = codes.astype(jnp.uint32)
    zero = jnp.zeros((B, W), dtype=jnp.uint32)
    flo, fhi, rlo, rhi = zero, zero, zero, zero
    ok = jnp.ones((B, W), dtype=bool)
    for i in range(k):
        ci = jax.lax.dynamic_slice_in_dim(c, i, W, axis=1)
        ok = ok & (ci <= 3)
        bitpos = 2 * (k - 1 - i)  # forward: base i sits at bits 2(k-1-i)
        if bitpos < 32:
            flo = flo | (ci << bitpos)
        else:
            fhi = fhi | (ci << (bitpos - 32))
        # reverse complement: base at window offset (k-1-i) complements into
        # the same bit position
        cj = jax.lax.dynamic_slice_in_dim(c, k - 1 - i, W, axis=1)
        comp = (jnp.uint32(3) - cj) & jnp.uint32(3)
        if bitpos < 32:
            rlo = rlo | (comp << bitpos)
        else:
            rhi = rhi | (comp << (bitpos - 32))
    take_fwd = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    lo = jnp.where(take_fwd, flo, rlo)
    hi = jnp.where(take_fwd, fhi, rhi)
    return lo, hi, ok


def mulhi32(a, c: int):
    """floor(a * c / 2^32) for uint32 a and 32-bit constant c, via 16-bit
    limbs (the graph stays 32-bit, see the module docstring)."""
    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> 16
    c0, c1 = c & 0xFFFF, c >> 16
    lo = a0 * jnp.uint32(c0)
    t = a1 * jnp.uint32(c0) + (lo >> 16)
    t2 = a0 * jnp.uint32(c1) + (t & jnp.uint32(0xFFFF))
    return a1 * jnp.uint32(c1) + (t >> 16) + (t2 >> 16)


# --- quotient dictionary (must match native pi62 / host_lookup exactly) ---

PI1 = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)
PI2 = (0x94D049BB133111EB, 0xD6E8FEB86659FD93)
HI62 = 0x3FFFFFFF  # mask for the high 30 bits of a 62-bit value


def _shr62(lo, hi, s: int):
    """(lo, hi) >> s for a 62-bit value in u32 limbs, 0 < s < 32."""
    return (lo >> s) | (hi << (32 - s)), hi >> s


def _mul62(lo, hi, c: int):
    """(lo, hi) * c mod 2^62 in u32 limbs (c is a 64-bit constant)."""
    c0, c1 = c & 0xFFFFFFFF, c >> 32
    res_lo = lo * jnp.uint32(c0)
    res_hi = mulhi32(lo, c0) + lo * jnp.uint32(c1) + hi * jnp.uint32(c0)
    return res_lo, res_hi & jnp.uint32(HI62)


def pi62_u32(lo, hi, consts):
    """Invertible 62-bit permutation on (lo32, hi30) limbs."""
    for step, c in ((31, consts[0]), (29, consts[1]), (31, None)):
        slo, shi = _shr62(lo, hi, step)
        lo, hi = lo ^ slo, hi ^ shi
        if c is not None:
            lo, hi = _mul62(lo, hi, c)
    return lo, hi


def probe(table: jax.Array, lo: jax.Array, hi: jax.Array, valid: jax.Array):
    """Quotient cuckoo probe. table: (nb, 4) uint32 rows = two little-endian
    u64 slots [val(b+1) | rem(62-b) | which(1)]; nb = 2^b. The invertible
    permutations make (bucket, rem, which) identify the key exactly (see
    native fn_cuckoo_build). One 16-byte row gather per hash choice.
    -> (hit bool, val uint32)."""
    nb = table.shape[0]
    b = nb.bit_length() - 1
    assert (1 << b) == nb
    val_bits = b + 1
    val_mask = jnp.uint32((1 << val_bits) - 1) if val_bits < 32 else jnp.uint32(0xFFFFFFFF)
    rem_hi_mask = jnp.uint32((1 << (30 - b)) - 1)

    hit = jnp.zeros(lo.shape, dtype=bool)
    val = jnp.full(lo.shape, INVALID_U32, dtype=jnp.uint32)
    for which, consts in ((0, PI1), (1, PI2)):
        plo, phi = pi62_u32(lo, hi, consts)
        bkt = (phi >> (30 - b)).astype(jnp.int32)
        rem_lo = plo
        rem_hi = phi & rem_hi_mask
        rows = jnp.take(table, bkt, axis=0)  # (..., 4)
        for s in range(2):
            slo = rows[..., 2 * s]
            shi = rows[..., 2 * s + 1]
            v = slo & val_mask
            r_lo = (slo >> val_bits) | (shi << (32 - val_bits))
            r_hi = (shi >> val_bits) & rem_hi_mask
            w = shi >> 31
            h = (
                (v != val_mask)
                & (w == jnp.uint32(which))
                & (r_lo == rem_lo)
                & (r_hi == rem_hi)
            )
            hit = hit | h
            val = jnp.where(h, v, val)
    hit = hit & valid
    val = jnp.where(hit, val, jnp.uint32(INVALID_U32))
    return hit, val


def lookup_batch(table, codes, k):
    """Full lookup: (B, L) codes -> per-window (hit, color_set_id).

    The dictionary value IS the color-set id: the reference's two-step
    contig_id -> rank1(u2c) (include/index.hpp:37) is folded into the table
    at build time, saving one gather per window on the device's
    gather-bound probe. Unitig identity lives host-side for
    tooling (dump/check/builders)."""
    lo, hi, ok = pack_windows(codes, k)
    hit, csid = probe(table, lo, hi, ok)
    return hit, csid
