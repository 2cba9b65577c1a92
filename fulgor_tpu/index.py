"""The fulgor-tpu index (reference L4: include/index.hpp).

Composition (hybrid kind; meta/diff variants layer on the color-set store):

    k-mer dictionary : default "mini" = minimizer-positional bucketless
                       dictionary (ops/minidict2.py): one 12 B entry per
                       minimizer RUN (~6.5 k-mers) verified against the
                       unitig text -> ~2-4 B/k-mer on disk, the SSHash-class
                       space point (reference include/index.hpp:13-14).
                       Alternative "cuckoo" = quotient cuckoo table with
                       invertible 62-bit permutations (~20 B/k-mer, fastest
                       probe; ops/lookup.py). Both fold u2c's rank into the
                       stored value (one less gather per window).
    unitig text      : concatenated 2-bit packed bases + base offsets
                       (replaces SSHash's packed contigs; used by dump()/
                       check tooling, not by the query hot path).
    u2c              : dense uint32 unitig_id -> color_set_id (the reference
                       stores a boundary bitmap + rank9 — a CPU-ism; dense
                       gather is the device layout).
    color sets       : one of four stores (core/colorstores.py: hybrid /
                       meta / diff / meta-diff); expanded at load into a
                       dense bitset matrix (num_sets, ceil(C/32)) for the
                       device.
    filenames        : reference names in color-id order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import INDEX_VERSION
from .constants import EXT, KIND_FROM_EXT
from .core import container
from .core import kmers as K
from .core.colorstores import STORE_CLASSES


def _print_nested(d, indent=0):
    pad = "  " * indent
    if isinstance(d, dict):
        for key, val in d.items():
            if isinstance(val, dict) or (
                isinstance(val, list) and val and isinstance(val[0], dict)
            ):
                print(f"{pad}{key}:")
                _print_nested(val, indent + 1)
            else:
                print(f"{pad}{key}: {val}")
    else:  # list of dicts
        for item in d:
            _print_nested(item, indent)


@dataclass
class Index:
    kind: str
    k: int
    m: int
    num_kmers: int
    num_colors: int
    filenames: list[str]

    # k-mer dictionary: ONE of two backends (dict_kind selects).
    #   "mini"   (default): minimizer-positional bucketless dictionary
    #            (ops/minidict2.py) — ~2-4 B/k-mer on disk, verifies against
    #            the unitig text (the SSHash-class design, SURVEY §7.3);
    #   "cuckoo": quotient cuckoo table (ops/lookup.py) — ~20 B/k-mer,
    #            2 gathers/window, kept for tooling oracles and comparison.
    dict_table: np.ndarray | None  # cuckoo (nb, 4) u32 rows; value = csid
    unitig_seq: np.ndarray  # uint64 2-bit packed concat
    unitig_offs: np.ndarray  # int64 (U+1,) base offsets
    u2c_csid: np.ndarray  # uint32 (U,)

    color_store: object  # Hybrid/Meta/Diff/MetaDiff store (core/colorstores)

    dict_kind: str = "cuckoo"
    mini_slots: np.ndarray | None = None  # (M2, 6) u32 paired entry slots
    mini_sec: np.ndarray | None = None  # (NR, 8) u32 skew pointer table
    mini_num_slots: int = 0  # fastrange modulus M

    _dense_bits: np.ndarray | None = field(default=None, repr=False)
    _cs_cache: tuple | None = field(default=None, repr=False)
    _mini_obj: object | None = field(default=None, repr=False)
    _row_memo: np.ndarray | None = field(default=None, repr=False)
    _row_pos: np.ndarray | None = field(default=None, repr=False)
    _row_n: int = field(default=0, repr=False)

    # ------------------------------------------------ basic accessors

    @property
    def num_unitigs(self) -> int:
        return len(self.unitig_offs) - 1

    @property
    def num_color_sets(self) -> int:
        return self.color_store.num_color_sets

    def u2c(self, unitig_id: int) -> int:
        return int(self.u2c_csid[unitig_id])

    # ------------------------------------------------ dictionary backend

    def minidict(self):
        """MiniDict2 view over this index's arrays (text32 derived from the
        packed unitig text — not stored twice)."""
        if self._mini_obj is None:
            from .ops.minidict2 import MiniDict2, text32_from_packed

            assert self.dict_kind == "mini"
            self._mini_obj = MiniDict2(
                k=self.k,
                m=self.m,
                slots=self.mini_slots,
                num_slots=self.mini_num_slots,
                text32=text32_from_packed(self.unitig_seq, int(self.unitig_offs[-1])),
                sec_table=self.mini_sec,
                spill_frac=-1.0,
                multi_tail=-1.0,
            )
        return self._mini_obj

    def device_dict(self):
        """(table_pytree, dparams) for ops/pipeline dict_probe: the arrays to
        ship to the device plus the static probe parameters."""
        if self.dict_kind == "cuckoo":
            return self.dict_table, None
        d = self.minidict()
        return (d.slots, d.text32, d.sec_table), (self.m, self.mini_num_slots)

    def host_window_csids(self, codes: np.ndarray):
        """Exact host lookup over every k-window of a 1-D code array.
        -> (hit bool (Wk,), csid u32 (Wk,) — INVALID_U32 where no hit)."""
        from .constants import INVALID_U32

        if self.dict_kind == "mini":
            from .ops.minidict2 import probe_windows_host

            hit, csid = probe_windows_host(self.minidict(), codes)
            return hit, np.where(hit, csid, np.uint32(INVALID_U32))
        from .query.host_lookup import lookup_host

        km, valid = K.pack_kmers(np.asarray(codes, dtype=np.uint8), self.k)
        out = np.full(len(km), INVALID_U32, dtype=np.uint32)
        if len(km):
            vals = lookup_host(self.dict_table, K.canonicalize(km, self.k))
            hitm = valid & (vals != INVALID_U32)
            out[hitm] = vals[hitm]
        return out != INVALID_U32, out

    def color_set(self, cs_id: int) -> np.ndarray:
        cat, offs = self.color_sets_decoded()
        return cat[offs[cs_id] : offs[cs_id + 1]]

    def color_sets_decoded(self):
        """(cat u32, offs i64) for all sets, cached. For meta/meta-diff
        kinds the color ids are the PERMUTED ids (filenames are stored in
        the same permuted order, reference README.md:222-231)."""
        if self._cs_cache is None:
            self._cs_cache = self.color_store.decode_all()
        return self._cs_cache

    def unitig_codes(self, i: int) -> np.ndarray:
        lo, hi = int(self.unitig_offs[i]), int(self.unitig_offs[i + 1])
        w0, w1 = lo >> 5, (hi + 31) >> 5
        codes = K.unpack2(self.unitig_seq[w0:w1], (w1 - w0) * 32)
        return codes[lo - (w0 << 5) : hi - (w0 << 5)]

    def unitig_seq_str(self, i: int) -> str:
        return K.codes_to_seq(self.unitig_codes(i))

    def expected_kmers_per_unitig(self) -> float:
        """Occurrence-weighted expected unitig k-mer count at a random READ
        position: unitig u is traversed by reads in proportion to its k-mer
        count TIMES how many genomes contain it (its color-set size), so
        E = sum(len_u^2 * |set_u|) / sum(len_u * |set_u|). This is the
        engine's streaming-locality signal (clonal pangenomes ~ hundreds;
        SNP-shredded graphs ~ 2-5) — the reference's streaming fast path
        (src/ps_full_intersection.cpp:341-353) exploits the same locality
        implicitly."""
        k = self.k
        ul = np.diff(self.unitig_offs)
        lens_k = np.maximum(0, ul - k + 1).astype(np.float64)
        _cat, offs = self.color_sets_decoded()
        ssz = (offs[1:] - offs[:-1]).astype(np.float64)
        w = ssz[self.u2c_csid.astype(np.int64)]
        den = float((lens_k * w).sum())
        return float((lens_k * lens_k * w).sum() / den) if den > 0 else 1.0

    # ------------------------------------------------ dense device view

    @property
    def words_per_set(self) -> int:
        return (self.num_colors + 31) // 32

    def dense_color_bits(self) -> np.ndarray:
        """(num_color_sets, ceil(C/32)) uint32 bitset matrix (cached).

        This is the device-side color-set representation: intersection is
        a gather + AND, threshold-union a (scores x bits) matmul. Memory is
        num_sets * C bits; past the engine's dense budget the no-dense paths
        decode rows on demand (color_rows).
        """
        if self._dense_bits is None:
            from .native import lib as _native

            cat, offs = self.color_sets_decoded()
            self._dense_bits = _native.dense_bits(
                cat, offs[:-1], offs[1:], self.num_colors
            )
        return self._dense_bits

    def color_rows(self, csids: np.ndarray) -> np.ndarray:
        """(len(csids), C32) uint32 bitset rows decoded ON DEMAND with a
        memo — the 150k-color regime's row source: the full dense matrix
        (num_sets x C bits) never materializes; only the distinct sets a
        query stream actually touches are decoded (on-demand compressed
        decode instead of a dense matrix).

        The memo is a growing 2D array + csid->row remap so the fan-out
        is ONE fancy index (a per-row python dict loop measured 50 s/batch
        of host time at 65k colors).
        Bounded by FULGOR_ROW_MEMO_BYTES (default 4 GiB): on overflow the
        memo resets — later batches re-decode their working set."""
        if self._dense_bits is not None:  # already paid for — use it
            return self._dense_bits[np.asarray(csids, dtype=np.int64)]
        import os as _os

        W = self.words_per_set
        cap_bytes = int(_os.environ.get("FULGOR_ROW_MEMO_BYTES",
                                        str(4 << 30)))
        if self._row_memo is None:
            self._row_memo = np.empty((4096, W), dtype=np.uint32)
            self._row_pos = np.full(self.num_color_sets, -1, dtype=np.int64)
            self._row_n = 0
        csids = np.asarray(csids, dtype=np.int64)
        pos = self._row_pos
        new = np.unique(csids[pos[csids] < 0])
        if len(new):
            if (self._row_n + len(new)) * 4 * W > cap_bytes:
                # memo full: reset (keeps peak bounded; the hot working
                # set re-decodes on the following batches)
                self._row_memo = np.empty((4096, W), dtype=np.uint32)
                pos.fill(-1)
                self._row_n = 0
                new = np.unique(csids)
            need = self._row_n + len(new)
            if need > len(self._row_memo):
                grow = max(need, 2 * len(self._row_memo))
                arr = np.empty((grow, W), dtype=np.uint32)
                arr[: self._row_n] = self._row_memo[: self._row_n]
                self._row_memo = arr
            from .native import lib as _native

            cat, offs = self.color_sets_decoded()
            rows = _native.dense_bits(cat, offs[new], offs[new + 1],
                                      self.num_colors)
            self._row_memo[self._row_n: self._row_n + len(new)] = rows
            pos[new] = self._row_n + np.arange(len(new), dtype=np.int64)
            self._row_n += len(new)
        return self._row_memo[pos[csids]]

    # ------------------------------------------------ serialization

    def save(self, path: str):
        meta = {
            "index_version": list(INDEX_VERSION),
            "k": self.k,
            "m": self.m,
            "num_kmers": self.num_kmers,
            "num_colors": self.num_colors,
            "num_unitigs": self.num_unitigs,
            "num_color_sets": self.num_color_sets,
        }
        meta["dict_kind"] = self.dict_kind
        fn_blob = "\n".join(self.filenames).encode()
        cs_arrays, cs_extra = self.color_store.arrays()
        arrays = {
            "unitig_seq": self.unitig_seq,
            "unitig_offs": self.unitig_offs,
            "u2c_csid": self.u2c_csid,
            "filenames": np.frombuffer(fn_blob, dtype=np.uint8),
        }
        if self.dict_kind == "cuckoo":
            arrays["dict_table"] = self.dict_table
        else:
            arrays["dict.slots"] = self.mini_slots
            arrays["dict.skew"] = self.mini_sec
            meta["dict_num_slots"] = self.mini_num_slots
            meta["dict_version"] = 3  # 3 = 15-bit fingerprint + strand
            # bit (2 = skew pointer table with 16-bit fingerprints)
        for name, arr in cs_arrays.items():
            arrays["cs." + name] = arr
        container.save(
            path, kind=self.kind, meta=meta, extra={"color_store": cs_extra}, arrays=arrays
        )

    @classmethod
    def load(cls, path: str) -> "Index":
        c = container.Container(path)
        fn_blob = c.array("filenames").tobytes().decode()
        meta = c.meta
        store = STORE_CLASSES[c.kind].from_arrays(
            c.extra["color_store"], lambda name: c.array("cs." + name)
        )
        dict_kind = meta.get("dict_kind", "cuckoo")
        dict_version = meta.get("dict_version", 1)
        mini_slots = c.array("dict.slots") if dict_kind == "mini" else None
        if dict_kind == "mini" and dict_version == 2:
            # v2 -> v3 upgrade on load: the 15 low fingerprint bits are
            # layout-identical; only the strand bit (bit 31) is recomputed
            # from the dictionary's own text (ops/minidict2.py docstring).
            # Soundness requires odd m (no m-mer equals its own reverse
            # complement); even-m v2 indexes cannot take the strand filter
            # and must be rebuilt (build_index now forces odd m).
            if int(meta["m"]) % 2 == 0:
                raise ValueError(
                    f"{path}: v2 mini dictionary built with even m="
                    f"{meta['m']} cannot be upgraded to the strand-bit "
                    "layout (palindromic m-mers); rebuild the index"
                )
            from .ops.minidict2 import text32_from_packed, upgrade_slots_v2_to_v3

            mini_slots = upgrade_slots_v2_to_v3(
                mini_slots,
                text32_from_packed(c.array("unitig_seq"),
                                   int(c.array("unitig_offs")[-1])),
                meta["m"],
            )
        elif dict_kind == "mini" and dict_version != 3:
            raise ValueError(
                f"{path}: mini-dictionary format v{dict_version} "
                "predates the skew pointer table; rebuild the index"
            )
        idx = cls(
            kind=c.kind,
            k=meta["k"],
            m=meta["m"],
            num_kmers=meta["num_kmers"],
            num_colors=meta["num_colors"],
            filenames=fn_blob.split("\n") if fn_blob else [],
            dict_table=c.array("dict_table") if dict_kind == "cuckoo" else None,
            unitig_seq=c.array("unitig_seq"),
            unitig_offs=c.array("unitig_offs"),
            u2c_csid=c.array("u2c_csid"),
            color_store=store,
            dict_kind=dict_kind,
            mini_slots=mini_slots,
            mini_sec=c.array("dict.skew") if dict_kind == "mini" else None,
            mini_num_slots=meta.get("dict_num_slots", 0),
        )
        assert meta["num_unitigs"] == idx.num_unitigs
        assert meta["num_color_sets"] == idx.num_color_sets
        return idx

    @staticmethod
    def path_for(basename: str, kind: str) -> str:
        return basename + EXT[kind]

    @staticmethod
    def kind_of(path: str) -> str:
        for ext, kind in KIND_FROM_EXT.items():
            if path.endswith(ext):
                return kind
        raise ValueError(f"unknown index extension: {path}")

    # ------------------------------------------------ stats

    def component_bytes(self) -> dict:
        if self.dict_kind == "cuckoo":
            dict_bytes = int(self.dict_table.nbytes)
        else:  # text32 is derived from unitig_text (counted there), not stored
            dict_bytes = int(self.mini_slots.nbytes + self.mini_sec.nbytes)
        return {
            "dictionary": dict_bytes,
            "unitig_text": int(self.unitig_seq.nbytes + self.unitig_offs.nbytes),
            "color_sets": int(self.color_store.num_bytes()),
            "u2c": int(self.u2c_csid.nbytes),
            "filenames": sum(len(f) for f in self.filenames) + 4 * len(self.filenames),
        }

    def print_stats(self):
        comp = self.component_bytes()
        total = sum(comp.values())
        print(f"total index size: {total} [B] -- {total / 1e9:.5f} [GB]")
        print("SPACE BREAKDOWN:")
        for name, nbytes in comp.items():
            print(f"  {name}: {nbytes} bytes / {nbytes / 1e9:.5f} GB ({100.0 * nbytes / total:.3f}%)")
        cat, offs = self.color_sets_decoded()
        nints = len(cat)
        print(f"Color id range 0..{self.num_colors - 1}")
        print(f"Number of distinct color sets: {self.num_color_sets}")
        print(
            f"Number of ints in distinct color sets: {nints} "
            f"({8.0 * comp['color_sets'] / max(1, nints):.5f} bits/int)"
        )
        print(f"k: {self.k}")
        print(f"m: {self.m} (nominal minimizer length)")
        print(
            f"Number of kmers in dBG: {self.num_kmers} "
            f"({8.0 * (comp['dictionary'] + comp['unitig_text']) / max(1, self.num_kmers):.5f} bits/kmer)"
        )
        print(f"Number of unitigs in dBG: {self.num_unitigs}")
        print(
            f"dictionary backend: {self.dict_kind} "
            f"({comp['dictionary'] / max(1, self.num_kmers):.2f} B/kmer + unitig text)"
        )
        print(f"color store [{self.kind}]:")
        _print_nested(self.color_store.stats(), indent=1)

    # ------------------------------------------------ dump / load (text interchange)

    def dump(self, basename: str):
        """Write the 4-file text dump (format: reference README.md:295-387)."""
        with open(basename + ".metadata.txt", "w") as f:
            f.write(f"k={self.k}\n")
            f.write(f"num_kmers={self.num_kmers}\n")
            f.write(f"num_colors={self.num_colors}\n")
            f.write(f"num_unitigs={self.num_unitigs}\n")
            f.write(f"num_color_sets={self.num_color_sets}\n")
        with open(basename + ".filenames.txt", "w") as f:
            for fn in self.filenames:
                f.write(fn + "\n")
        codes_all = K.unpack2(self.unitig_seq, int(self.unitig_offs[-1]))
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        with open(basename + ".unitigs.fa", "wb") as f:
            for i in range(self.num_unitigs):
                f.write(b"> color_set_id=%d\n" % self.u2c_csid[i])
                seg = lut[codes_all[self.unitig_offs[i] : self.unitig_offs[i + 1]]]
                f.write(seg.tobytes())
                f.write(b"\n")
        cat, offs = self.color_sets_decoded()
        with open(basename + ".color_sets.txt", "w") as f:
            for s in range(self.num_color_sets):
                row = cat[offs[s] : offs[s + 1]]
                f.write(f"size={len(row)} " + " ".join(map(str, row)) + "\n")

    @classmethod
    def from_dump(cls, basename: str, m: int = 20) -> "Index":
        """GGCAT-free construction from dump files (reference src/index.cpp:122-305)."""
        from .build.builder import assemble_index

        meta = {}
        with open(basename + ".metadata.txt") as f:
            for line in f:
                key, val = line.strip().split("=")
                meta[key] = int(val)
        k = meta["k"]
        with open(basename + ".filenames.txt") as f:
            filenames = [ln.rstrip("\n") for ln in f if ln.strip()]
        from .native import lib as native

        codes_mat, lens, names = native.parse_reads(basename + ".unitigs.fa")
        ucs = np.array([int(n.split("=")[1]) for n in names], dtype=np.uint32)
        uoffs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
        ucodes = np.concatenate(
            [codes_mat[i, : lens[i]] for i in range(len(lens))]
        ) if len(lens) else np.empty(0, np.uint8)
        sizes = []
        cols = []
        with open(basename + ".color_sets.txt") as f:
            for ln in f:
                parts = ln.split()
                n = int(parts[0].split("=")[1])
                assert n == len(parts) - 1
                sizes.append(n)
                cols.append(np.array(parts[1:], dtype=np.uint32))
        cs_offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        cs_colors = np.concatenate(cols).astype(np.uint32) if cols else np.empty(0, np.uint32)
        idx = assemble_index(
            k=k,
            m=m,
            num_colors=meta["num_colors"],
            filenames=filenames,
            unitig_codes=ucodes,
            unitig_offs=uoffs,
            unitig_cs=ucs,
            cs_colors=cs_colors,
            cs_offs=cs_offs,
        )
        assert idx.num_kmers == meta["num_kmers"], "kmer count mismatch vs dump metadata"
        return idx
