"""Exact replay of the FindBreakpoints scanner state machine.

This is a faithful re-implementation of the reference's templated scanner
(src/FindBreakpoints.hpp): the 256-slot k-mer history with unsigned-char
indices, the gap/solid stretch logic with Bloom-FP tolerance, the observer
cascade, and the writers. The per-position graph quantities come
pre-computed in device "planes" (scan.py); observers make sparse point
queries through the ScanContext helpers.

Positions handed to writers are 0-based here and converted to 1-based at
write time, exactly like the reference (writeBreakpoint/writeVcfVariant,
src/FindBreakpoints.hpp:640-702).

A frozen copy of the port's host automaton (`find -automaton host`), kept
here as the benchmark's plain reference for `find`: later changes to the
program do not move it. It runs with the observers of observers.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import kmers as K
from .kmers import canonical_int
from .planes import Planes

U64 = (1 << 64) - 1

STR_HOM_TYPE = "HOM"
STR_HET_TYPE = "HET"
STR_SNP_TYPE = "SNP"
STR_DEL_TYPE = "DEL"
STR_BKP_TYPE = "BACKUP"


@dataclass
class Info:
    """History slot (info_type, src/FindBreakpoints.hpp:61-67)."""

    kmer: int = 0
    nb_in: int = 0
    nb_out: int = 0
    is_repeated: bool = False

    def copy(self):
        return Info(self.kmer, self.nb_in, self.nb_out, self.is_repeated)


@dataclass
class Kmer:
    """A (forward-value, validity) pair standing in for KmerCanonical."""

    fwd: int = 0
    valid: bool = False


@dataclass
class FindStats:
    homo_clean: int = 0
    homo_fuzzy: int = 0
    hetero_clean: int = 0
    hetero_fuzzy: int = 0
    fuzzy_deletion: int = 0
    clean_deletion: int = 0
    solo_snp: int = 0
    multi_snp: int = 0
    backup: int = 0
    homo_clean_indel: int = 0
    homo_fuzzy_indel: int = 0
    hetero_indel: int = 0


class ScanContext:
    """FindBreakpoints equivalent: scanner state + observer services."""

    def __init__(
        self,
        graph,
        repeat_set,
        k: int,
        breakpoint_file,
        vcf_file,
        max_repeat: int = 5,
        snp_min_val: int = 5,
        branching_threshold: int = 15,
        homo_only: bool = False,
    ):
        self.graph = graph
        self.repeat_set = repeat_set
        self.k = k
        self.max_repeat = max_repeat
        self.snp_min_val = snp_min_val
        self.branching_threshold = branching_threshold
        self.homo_only = homo_only

        self.breakpoint_file = breakpoint_file
        self.vcf_file = vcf_file

        self.gap_obs = []
        self.kmer_obs = []

        self.breakpoint_id = 1
        self.position = 0
        self.chrom_seq = ""
        self.chrom_name = ""

        self.kmer_begin = Kmer()
        self.kmer_end = Kmer()
        self.previous_kmer = Kmer()  # persists across sequences, like the member

        self.solid_stretch_size = 0
        self.gap_stretch_size = 0

        self.history = [Info() for _ in range(256)]
        self.het_kmer_begin_index = 0  # set per sequence
        self.het_kmer_end_index = 0
        self.current_info = Info()
        self.recent_hetero = 0
        self.kmer_end_is_repeated = False
        self.kmer_begin_is_repeated = False

        self.stats = FindStats()
        self._planes: Planes | None = None
        self._plane_idx = 0

    # ------------------------------------------------------------------
    # graph/point-query services (IFindObserver helpers,
    # src/IFindObserver.hpp:85-117 and FindBreakpoints getters); these
    # operate on python-int kmers and work for every span (any k)
    # ------------------------------------------------------------------
    def contains(self, kmer: int) -> bool:
        """Canonical membership (IFindObserver::contains)."""
        return self.graph.contains_canon_int(canonical_int(kmer, self.k))

    def nb_in_branch(self, kmer: int) -> int:
        return self.graph.indegree_int(kmer)

    def nb_out_branch(self, kmer: int) -> int:
        return self.graph.outdegree_int(kmer)

    def suffix_is_repeated(self, kmer: int) -> bool:
        km1 = self.k - 1
        suffix = kmer & ((1 << (2 * km1)) - 1)
        return self.repeat_set.contains_int(canonical_int(suffix, km1))

    def ref_bloom_contains(self, canon_km1: int) -> bool:
        return self.repeat_set.contains_int(canon_km1)

    def to_string(self, kmer: int) -> str:
        return K.kmer_to_str(kmer, self.k)

    def code_seed_valid(self, s: str) -> bool:
        """model.codeSeed(chars).isValid(): k chars, all ACGT."""
        if len(s) < self.k:
            return False
        w = s[: self.k]
        return all(c in "ACGTacgt" for c in w)

    def seq_kmers_all_contained(self, seq: str, upto: int | None = None) -> bool:
        """All k-mers of seq present (canonical membership), used by the
        deletion / micro-insertion validators."""
        n = len(seq) - self.k + 1
        if upto is not None:
            n = min(n, upto)
        v = 0
        for i in range(n):
            if not self.contains(K.str_to_kmer(seq[i : i + self.k])):
                return False
            v += 1
        return v == n

    def count_leading_contained(self, seq: str) -> int:
        """#consecutive contained k-mers from the start of seq."""
        c = 0
        for i in range(len(seq) - self.k + 1):
            if self.contains(K.str_to_kmer(seq[i : i + self.k])):
                c += 1
            else:
                break
        return c

    # ------------------------------------------------------------------
    # writers (src/FindBreakpoints.hpp:640-702)
    # ------------------------------------------------------------------
    def write_breakpoint(
        self,
        bkt_id: int,
        chrom_name: str,
        position: int,
        kmer_begin: str,
        kmer_end: str,
        repeat_size: int,
        btype: str,
        repeat_in_genome_kmer_begin: bool = False,
        repeat_in_genome_kmer_end: bool = False,
    ):
        pos1 = (position + 1) & U64  # %lli of uint64 expression, 1-based
        self.breakpoint_file.write(
            ">bkpt%i_%s_pos_%i_fuzzy_%i_%s %s left_kmer\n%s\n"
            ">bkpt%i_%s_pos_%i_fuzzy_%i_%s %s right_kmer\n%s\n"
            % (
                bkt_id, chrom_name, pos1, repeat_size, btype,
                "REPEATED" if repeat_in_genome_kmer_begin else "",
                kmer_begin,
                bkt_id, chrom_name, pos1, repeat_size, btype,
                "REPEATED" if repeat_in_genome_kmer_end else "",
                kmer_end,
            )
        )

    def write_vcf_variant(self, bkt_id, chrom_name, position, ref_str, alt_str, repeat_size, vtype):
        variant_size = 1
        if vtype == STR_DEL_TYPE:
            variant_size = len(ref_str) - 1
        self.vcf_file.write(
            "%s\t%i\tbkpt%i\t%s\t%s\t.\tPASS\tTYPE=%s;LEN=%i;FUZZY=%i\tGT\t1/1\n"
            % (chrom_name, (position + 1) & U64, bkt_id, ref_str, alt_str, vtype, variant_size, repeat_size)
        )

    def write_indel(self, bkt_id, chrom_name, position, ref_str, alt_str, repeat_size, itype):
        variant_size = len(alt_str) - 1
        gt = "./."
        if itype == "HOM":
            gt = "1/1"
        if itype == "HET":
            gt = "0/1"
        self.vcf_file.write(
            "%s\t%i\tbkpt%i\t%s\t%s\t.\tPASS\tTYPE=INS;LEN=%i;FUZZY=%i\tGT\t%s\n"
            % (chrom_name, (position + 1) & U64, bkt_id, ref_str, alt_str, variant_size, repeat_size, gt)
        )

    # counter iterators -------------------------------------------------
    def breakpoint_id_iterate(self):
        self.breakpoint_id += 1

    # ------------------------------------------------------------------
    # the scanner itself (operator() + notify,
    # src/FindBreakpoints.hpp:370-455 and 560-622)
    # ------------------------------------------------------------------
    def add_gap_observer(self, obs):
        self.gap_obs.append(obs)

    def add_kmer_observer(self, obs):
        self.kmer_obs.append(obs)

    def scan_sequence(self, name: str, seq: str, planes: Planes, bed_intervals=None):
        """Scan one chromosome. bed_intervals: ordered [(start,end)] or None."""
        self.kmer_begin = Kmer()
        self.kmer_end = Kmer()
        self.solid_stretch_size = 0
        self.gap_stretch_size = 0
        self.history = [Info() for _ in range(256)]
        self.het_kmer_end_index = (self.k + 1) % 256
        self.het_kmer_begin_index = 1
        self.recent_hetero = 0
        self.chrom_seq = seq
        self.chrom_name = name
        self.position = 0
        self._planes = planes

        n = len(planes)
        if bed_intervals is None:
            i = 0
            while i < n:
                self._plane_idx = i
                if not planes.valid[i]:
                    self.solid_stretch_size = 0
                    self.gap_stretch_size = 0
                    self.kmer_begin = Kmer()
                    self.kmer_end = Kmer()
                else:
                    save_position = self.position
                    self.notify(i)
                    self.position = save_position
                    self.previous_kmer = Kmer(int(planes.fwd[i]), True)
                # loop increments (position and history indices move together,
                # except when MultiSNPrev rewound the history indices)
                i += 1
                self.position += 1
                self.het_kmer_begin_index = (self.het_kmer_begin_index + 1) % 256
                self.het_kmer_end_index = (self.het_kmer_end_index + 1) % 256
        else:
            if not bed_intervals:
                return
            intervals = list(bed_intervals)
            start_pos, end_pos = intervals[0]
            i = 0
            while i < n:
                self._plane_idx = i
                if self.position >= end_pos:
                    intervals.pop(0)
                    if not intervals:
                        break
                    start_pos, end_pos = intervals[0]
                if not planes.valid[i]:
                    self.solid_stretch_size = 0
                    self.gap_stretch_size = 0
                    self.kmer_begin = Kmer()
                    self.kmer_end = Kmer()
                if self.position == start_pos - 1:
                    self.solid_stretch_size = 0
                    self.gap_stretch_size = 0
                    self.kmer_begin = Kmer()
                    self.kmer_end = Kmer()
                    self.history = [Info() for _ in range(256)]
                if planes.valid[i] and self.position >= start_pos:
                    save_position = self.position
                    self.notify(i)
                    self.position = save_position
                    self.previous_kmer = Kmer(int(planes.fwd[i]), True)
                i += 1
                self.position += 1
                self.het_kmer_begin_index = (self.het_kmer_begin_index + 1) % 256
                self.het_kmer_end_index = (self.het_kmer_end_index + 1) % 256

    def notify(self, i: int):
        p = self._planes
        in_graph = bool(p.contains[i])
        self._store_kmer_info(i)

        for obs in self.kmer_obs:
            obs.update()

        if in_graph:  # kmer validity already checked by caller
            self.solid_stretch_size += 1
            if self.solid_stretch_size > 1 and self.gap_stretch_size > 0:
                for obs in self.gap_obs:
                    if obs.update():
                        break
                self.gap_stretch_size = 0
            if self.solid_stretch_size == 1:
                self.kmer_end = Kmer(int(p.fwd[i]), True)
        else:
            if self.solid_stretch_size == 1:
                # an isolated solid kmer inside a gap is likely a FP: fold it
                # back into the gap
                self.gap_stretch_size += self.solid_stretch_size
            if self.solid_stretch_size > 1 and self.previous_kmer.valid:
                self.kmer_begin = Kmer(self.previous_kmer.fwd, True)
                self.kmer_begin_is_repeated = self.current_info.is_repeated
            self.gap_stretch_size += 1
            self.solid_stretch_size = 0

    def _store_kmer_info(self, i: int):
        p = self._planes
        self.current_info = Info(
            kmer=int(p.fwd[i]),
            nb_in=int(p.nb_in[i]),
            nb_out=int(p.nb_out[i]),
            is_repeated=bool(p.suffix_rep[i]),
        )
        self.history[self.het_kmer_end_index] = self.current_info.copy()
        self.kmer_end_is_repeated = bool(p.prefix_rep[i])
