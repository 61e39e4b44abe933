"""ctypes bridge to the native find-scan automaton (native/automaton.cpp).

The C++ scanner consumes the per-position planes at native speed and emits
the exact .breakpoints / .othervariants.vcf record text the python automaton
would produce (differential-tested in tests/test_native_automaton.py).
All spans k <= 256: kmers are ceil(k/32)-word rows (the ops/span.py layout);
the C side dispatches on the word count."""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import native_library

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = native_library("automaton.cpp", "libmtgautomaton.so", ("-O3", "-march=native"))
        lib.scanner_create_span.restype = ctypes.c_void_p
        lib.scanner_create_span.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.scanner_scan_sequence.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.scanner_begin_sequence.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.scanner_feed_pay.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.scanner_feed_cls.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.scanner_bkpt_size.restype = ctypes.c_int64
        lib.scanner_bkpt_size.argtypes = [ctypes.c_void_p]
        lib.scanner_vcf_size.restype = ctypes.c_int64
        lib.scanner_vcf_size.argtypes = [ctypes.c_void_p]
        lib.scanner_bkpt.restype = ctypes.c_void_p
        lib.scanner_bkpt.argtypes = [ctypes.c_void_p]
        lib.scanner_vcf.restype = ctypes.c_void_p
        lib.scanner_vcf.argtypes = [ctypes.c_void_p]
        lib.scanner_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
        lib.scanner_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


STAT_NAMES = [
    "homo_clean", "homo_fuzzy", "hetero_clean", "hetero_fuzzy",
    "fuzzy_deletion", "clean_deletion", "solo_snp", "multi_snp",
    "backup", "homo_clean_indel", "homo_fuzzy_indel", "hetero_indel",
]


class NativeScanner:
    """Holds the scanner across sequences (breakpoint ids and counters are
    run-global, like the reference Tool)."""

    def __init__(self, graph, repeat_set, k, *, max_repeat, snp_min_val,
                 branching_threshold, homo_only, snp, deletion, small_homo,
                 homo_insert, backup, hete_insert):
        lib = _load()
        assert lib is not None and k <= 256
        self._lib = lib
        self.k = k
        self.words = max(1, -(-k // 32))
        if k <= 32:
            self._solid = np.ascontiguousarray(graph.solid.keys, dtype=np.uint64)
            self._repeat = np.ascontiguousarray(repeat_set.keys, dtype=np.uint64)
            n_solid, n_repeat = self._solid.size, self._repeat.size
        else:
            # multi-word: sorted void keys -> (N, W) uint64 rows (same order:
            # big-endian word rows compare like the void keys)
            from ..ops.span import Span

            sp = Span(k)
            self._solid = np.ascontiguousarray(sp.from_keys(graph.solid.keys))
            if repeat_set.span is None:  # k = 33: (k-1)-mer set is plain u64
                self._repeat = np.ascontiguousarray(
                    np.asarray(repeat_set.keys, np.uint64).reshape(-1, 1)
                )
            else:
                self._repeat = np.ascontiguousarray(
                    Span(k - 1).from_keys(repeat_set.keys)
                )
            n_solid, n_repeat = self._solid.shape[0], self._repeat.shape[0]
        self._h = lib.scanner_create_span(
            k, self.words, max_repeat, snp_min_val, branching_threshold,
            int(homo_only), int(snp), int(deletion), int(small_homo),
            int(homo_insert), int(backup), int(hete_insert),
            self._solid.ctypes.data_as(ctypes.c_void_p), n_solid,
            self._repeat.ctypes.data_as(ctypes.c_void_p), n_repeat,
        )

    def scan_sequence(self, name: str, seq: str, planes, bed_intervals=None):
        valid = np.ascontiguousarray(planes.valid, dtype=np.uint8)
        if self.k <= 32:
            fwd = np.ascontiguousarray(planes.fwd, dtype=np.uint64)
        else:
            assert planes.fwd_rows is not None, "k > 32 native scan needs fwd_rows"
            fwd = np.ascontiguousarray(planes.fwd_rows, dtype=np.uint64)
        contains = np.ascontiguousarray(planes.contains, dtype=np.uint8)
        nb_in = np.ascontiguousarray(planes.nb_in, dtype=np.int32)
        nb_out = np.ascontiguousarray(planes.nb_out, dtype=np.int32)
        suffix_rep = np.ascontiguousarray(planes.suffix_rep, dtype=np.uint8)
        prefix_rep = np.ascontiguousarray(planes.prefix_rep, dtype=np.uint8)
        if bed_intervals is None:
            bed = None
            n_bed = -1
        else:
            flat = [x for iv in bed_intervals for x in iv]
            bed = np.ascontiguousarray(flat, dtype=np.int64) if flat else np.zeros(0, np.int64)
            n_bed = len(flat)
        seq_b = seq.encode("ascii")
        self._lib.scanner_scan_sequence(
            self._h, name.encode(), seq_b, len(seq_b), valid.size,
            valid.ctypes.data_as(ctypes.c_void_p),
            fwd.ctypes.data_as(ctypes.c_void_p),
            contains.ctypes.data_as(ctypes.c_void_p),
            nb_in.ctypes.data_as(ctypes.c_void_p),
            nb_out.ctypes.data_as(ctypes.c_void_p),
            suffix_rep.ctypes.data_as(ctypes.c_void_p),
            prefix_rep.ctypes.data_as(ctypes.c_void_p),
            bed.ctypes.data_as(ctypes.c_void_p) if bed is not None and bed.size else None,
            n_bed,
        )

    def scan_sequence_pay(self, name: str, seq: str, chunks, bed_intervals=None):
        """Packed-payload scan: feed the device's payload stream straight
        into the C automaton — no host plane expansion. `chunks` iterates
        tagged tuples:

          ("pay", pay_u8, rep_bits_u8, str_bits_u8 | None, n) — explicit
            payload bytes; rep/str bit t (np.unpackbits order) belongs to
            the chunk's local entry t; str None = pre-oriented (qp map)
          ("cls", cls2_u8, exc16_u16, n_exc, n) — reference-delta stream
            (scan_cls_device_qp): 2-bit classes, exceptions in order

        Byte-identical to scan_sequence over the expanded planes
        (differential-tested)."""
        if bed_intervals is None:
            bed, n_bed = None, -1
        else:
            flat = [x for iv in bed_intervals for x in iv]
            bed = np.ascontiguousarray(flat, dtype=np.int64) if flat else np.zeros(0, np.int64)
            n_bed = len(flat)
        seq_b = seq.encode("ascii")  # must outlive the feeds (C keeps the ptr)
        self._lib.scanner_begin_sequence(
            self._h, name.encode(), seq_b, len(seq_b),
            bed.ctypes.data_as(ctypes.c_void_p) if bed is not None and bed.size else None,
            n_bed,
        )
        for chunk in chunks:
            if chunk[0] == "cls":
                _, cls2, exc16, n_exc, n = chunk
                cls2 = np.ascontiguousarray(cls2, np.uint8)
                exc16 = np.ascontiguousarray(exc16, np.uint16)
                self._lib.scanner_feed_cls(
                    self._h, cls2.ctypes.data_as(ctypes.c_void_p),
                    exc16.ctypes.data_as(ctypes.c_void_p), int(n_exc), int(n),
                )
                continue
            _, pay, rep, strb, n = chunk
            pay = np.ascontiguousarray(pay, np.uint8)
            rep = np.ascontiguousarray(rep, np.uint8)
            strp = None
            if strb is not None:
                strb = np.ascontiguousarray(strb, np.uint8)
                strp = strb.ctypes.data_as(ctypes.c_void_p)
            self._lib.scanner_feed_pay(
                self._h, pay.ctypes.data_as(ctypes.c_void_p),
                rep.ctypes.data_as(ctypes.c_void_p), strp, int(n),
            )

    def results(self):
        lib = self._lib
        bkpt = ctypes.string_at(lib.scanner_bkpt(self._h), lib.scanner_bkpt_size(self._h)).decode()
        vcf = ctypes.string_at(lib.scanner_vcf(self._h), lib.scanner_vcf_size(self._h)).decode()
        stats_arr = (ctypes.c_longlong * 12)()
        lib.scanner_stats(self._h, stats_arr)
        stats = dict(zip(STAT_NAMES, list(stats_arr)))
        return bkpt, vcf, stats

    def close(self):
        if self._h:
            self._lib.scanner_free(self._h)
            self._h = None
